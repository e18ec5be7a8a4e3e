"""Real-footage image bank for fine-tuning.

The self-supervised trainer renders shaky clips from base images and
supervises against the known jitter path (train/synthetic.py). By default
the base images are procedural multi-octave noise; this module lets them
come from the user's OWN footage instead — decode a video (or frame dir),
take random crops at model resolution, and hand the resulting bank to the
train loop. The jitter path, targets, and losses are untouched, so the
ground-truth supervision stays exact while the texture distribution
becomes the deployment footage (the domain-adaptation story).

Bank construction is one-time host work (numpy + cv2); training itself
never touches the host again — the bank lives on device and the train
step gathers random rows from it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from dvsg_tpu_torch.utils import video_io


def _crop_resize(frame: np.ndarray, model_hw: Tuple[int, int],
                 rng: np.random.Generator) -> np.ndarray:
    """One random model-aspect crop, resized to model resolution.

    Crop scale is uniform between model size and the largest model-aspect
    window that fits (small crops add texture-scale diversity). When the
    source is below model resolution in some dimension, the largest
    fitting model-aspect window is cropped at a random position along the
    non-deficient axis and upscaled — the aspect ratio is never squashed
    and crops keep positional diversity (an earlier version returned the
    full squashed frame, collapsing the whole bank to identical images).
    """
    import cv2

    mh, mw = model_hw
    h, w = frame.shape[:2]
    max_s = min(h / mh, w / mw)
    s = rng.uniform(min(1.0, max_s), max_s)
    ch = min(h, max(1, int(round(mh * s))))
    cw = min(w, max(1, int(round(mw * s))))
    y0 = rng.integers(0, h - ch + 1)
    x0 = rng.integers(0, w - cw + 1)
    crop = frame[y0:y0 + ch, x0:x0 + cw]
    if (ch, cw) != (mh, mw):
        interp = cv2.INTER_AREA if ch >= mh else cv2.INTER_LINEAR
        crop = cv2.resize(crop, (mw, mh), interpolation=interp)
    return crop


def _clip_length(path: str) -> int:
    """Frame count of a clip without decoding it.

    Frame dirs and most containers report it directly; otherwise one
    decode-free grab() pass counts the stream.
    """
    with video_io.VideoReader(path) as reader:
        if reader.num_frames is not None:
            return reader.num_frames
        return reader.skip(1 << 30)


def iter_sampled_frames(path: str, num: int):
    """Yield (frame, count) over evenly-sampled frames of a clip.

    ``num`` sample positions are spread linspace-evenly over the clip and
    deduplicated: each yielded uint8 RGB frame carries the number of
    sample positions that landed on it (counts sum to ``num``, short only
    if container metadata overcounted the stream). Only the sampled
    frames are decoded — decode-free skip between them — so memory and
    decode work stay O(num), not O(clip). Shared by the fine-tuning bank
    below and ``dvsg-eval --stills``.
    """
    n = _clip_length(path)
    if n == 0:
        raise ValueError(f"no frames decoded from {path!r}")
    order = np.linspace(0, n - 1, num).round().astype(int)
    uniq, counts = np.unique(order, return_counts=True)  # sorted
    with video_io.VideoReader(path) as reader:
        pos = 0
        for fi, cnt in zip(uniq, counts):
            if fi > pos:
                pos += reader.skip(int(fi) - pos)
                if pos != fi:
                    return  # container metadata overcounted the stream
            frame = reader.read()
            if frame is None:
                return
            pos += 1
            yield frame, int(cnt)


def build_image_bank(path: str, model_hw: Tuple[int, int],
                     num_images: int = 256, seed: int = 0) -> np.ndarray:
    """Decode footage and return a (N, mh, mw, 3) f32 bank in [0, 1].

    ``path`` is a video container or a frame directory (anything
    video_io.VideoReader accepts). Frames are sampled evenly across the
    clip; each bank image is an independent random crop, so a short clip
    still yields a diverse bank. Only the sampled frames are decoded
    (decode-free skip between them), so memory stays O(bank), not
    O(clip) — fine-tuning footage can be arbitrarily long.
    """
    mh, mw = model_hw
    rng = np.random.default_rng(seed)
    bank = np.empty((num_images, mh, mw, 3), np.float32)
    i = 0
    last = None
    for frame, cnt in iter_sampled_frames(path, num_images):
        last = frame
        for _ in range(cnt):
            bank[i] = _crop_resize(frame, (mh, mw), rng)
            i += 1
    if i == 0:
        raise ValueError(f"no frames decoded from {path!r}")
    while i < num_images:  # overcounted metadata: fresh crops, last frame
        bank[i] = _crop_resize(last, (mh, mw), rng)
        i += 1
    bank /= 255.0
    return bank


def build_image_bank_multi(paths: Sequence[str], model_hw: Tuple[int, int],
                           num_images: int = 256, seed: int = 0
                           ) -> np.ndarray:
    """Bank drawn round-robin from several clips (num_images split evenly;
    the remainder goes to the first clips)."""
    if not paths:
        raise ValueError("need at least one input path")
    per = num_images // len(paths)
    extra = num_images - per * len(paths)
    parts = []
    for i, p in enumerate(paths):
        n = per + (1 if i < extra else 0)
        if n:
            parts.append(build_image_bank(p, model_hw, n, seed=seed + i))
    return np.concatenate(parts, axis=0)
