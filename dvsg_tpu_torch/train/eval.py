"""Stabilization quality evaluation on synthetic-jitter clips.

Ground truth is constructible without a reference output: frame t of a
synthetic clip is the still seen through jitter A_t; the ideal stabilizer
output for the pipeline's causal window is the still seen through the
window-MEAN pose Ā_t (the smoothed camera path). We report:

  * psnr_vs_target: PSNR(output_t, still ∘ Ā_t) over interior pixels —
    fidelity to the achievable ground truth.
  * psnr_identity: PSNR(input_t, still ∘ Ā_t) — the do-nothing baseline;
    a working model must beat it.
  * stability_gain: mean interior frame-to-frame pixel change of the
    output relative to the input (< 1 means steadier video).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
from dvsg_tpu_torch.train import synthetic
from dvsg_tpu_torch.utils.metrics import psnr

_BORDER = 0.125


def smoothed_targets(still: torch.Tensor, path: torch.Tensor, window: int
                     ) -> torch.Tensor:
    """Per-frame achievable targets (T, H, W, C): still ∘ (window-mean
    jitter).

    Mirrors the pipeline's causal window (frames t-N+1..t, replicate-padded
    at the start), matching train/loop.py supervision.
    """
    padded = torch.cat([path[:1].expand(window - 1, -1), path])
    means = padded.unfold(0, window, 1).mean(dim=-1)             # (T, 5)
    return synthetic.jitter_frames(still, means)


def _interior(a: np.ndarray) -> np.ndarray:
    h, w = a.shape[-3], a.shape[-2]
    bh, bw = int(h * _BORDER), int(w * _BORDER)
    return a[..., bh:h - bh, bw:w - bw, :]


def _steadiness(frames: np.ndarray) -> float:
    """Mean interior frame-to-frame absolute change (lower = steadier)."""
    f = _interior(frames).astype(np.float64) / 255.0
    return float(np.abs(np.diff(f, axis=0)).mean())


def evaluate_synthetic(stab: Stabilizer, generator: torch.Generator,
                       num_frames: int, height: int, width: int,
                       track_metrics: bool = False,
                       still=None) -> Dict[str, float]:
    """Synthetic-jitter quality report (ground-truth PSNR + steadiness);
    the clip is rendered on the stabilizer's device.

    ``track_metrics`` adds the literature's no-ground-truth trio —
    stability score, cropping ratio, distortion value — estimated by
    feature tracking (utils/stab_metrics.py); host-side cv2 work, so
    off by default in tight loops.

    ``still`` (optional, (height, width, 3) f32 in [0,1]) replaces the
    procedural base image, so quality is measurable on USER imagery with
    the same exact ground truth.
    """
    dev = stab.device
    if still is None:
        frames_u8, still_u8, path = synthetic.synthetic_clip_u8(
            generator, num_frames, height, width, device=dev)
    else:
        still = torch.as_tensor(np.asarray(still), dtype=torch.float32
                                ).to(dev)
        if tuple(still.shape) != (height, width, 3):
            raise ValueError(f"still must be ({height}, {width}, 3), "
                             f"got {tuple(still.shape)}")
        path = synthetic.random_camera_path(generator, num_frames,
                                            device=dev)
        frames_u8 = synthetic.to_u8(synthetic.jitter_frames(still, path))
        still_u8 = synthetic.to_u8(still)
    frames_np = frames_u8.cpu().numpy()

    out = stab.stabilize_clip(frames_np)

    targets = smoothed_targets(still_u8.to(torch.float32) / 255.0, path,
                               stab.cfg.model.window)
    targets_np = synthetic.to_u8(targets).cpu().numpy()

    psnr_out = psnr(_interior(out), _interior(targets_np))
    psnr_in = psnr(_interior(frames_np), _interior(targets_np))
    steadiness_in = _steadiness(frames_np)
    steadiness_out = _steadiness(out)
    report = {
        "psnr_vs_target": psnr_out,
        "psnr_identity": psnr_in,
        "psnr_gain_db": psnr_out - psnr_in,
        "steadiness_in": steadiness_in,
        "steadiness_out": steadiness_out,
        "stability_gain": (steadiness_out / steadiness_in
                           if steadiness_in > 0 else 1.0),
        "frames": float(num_frames),
    }
    if track_metrics:
        from dvsg_tpu_torch.utils import stab_metrics
        report.update(stab_metrics.stability_report(frames_np, out))
    return report
