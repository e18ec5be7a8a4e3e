#!/usr/bin/env python
"""Long-horizon camera-path smoothing with the PyTorch port: remove drift
and sway, not just jitter.

The motion CNN corrects each frame toward the mean pose of its short
temporal window, so fast shake disappears but slow sway (a period longer
than the window) passes through. ``path_smooth`` adds the missing stage:
the camera path is measured chunk by chunk (phase correlation on the
model-resolution frames the pipeline already computes) and low-passed
with an EMA of the horizon you pick; ``path_smooth_lag`` smooths with a
zero-phase filter over a D-frame lookahead instead.

This example renders a clip with sinusoidal sway plus jitter, stabilizes
it plain, smoothed and smoothed with a lag, and reports the tracked
output path RMS of each (the tracking needs OpenCV).

    python examples/torch/07_path_smoothing.py [--device cpu]
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--horizon", type=int, default=32,
                    help="EMA horizon in frames (the --path-smooth value)")
    ap.add_argument("--lag", type=int, default=16,
                    help="fixed-lag lookahead of the third run (the "
                         "--path-smooth-lag value)")
    args = ap.parse_args()

    import numpy as np
    import torch

    from dvsg_tpu_torch import resolve_device
    from dvsg_tpu_torch.config import StabilizeConfig
    from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
    from dvsg_tpu_torch.train import synthetic
    from dvsg_tpu_torch.utils import checkpoint as ckpt
    from dvsg_tpu_torch.utils import stab_metrics

    dev = resolve_device(args.device)
    params, mcfg = ckpt.load_npz(
        os.path.join(ROOT, "checkpoints", "flagship_fast.npz"))

    # Sway (periods 40 and 56 frames, invisible to the 5-frame window) on
    # top of white jitter (what the CNN removes).
    t = np.arange(args.frames)
    rng = np.random.default_rng(0)
    path5 = np.zeros((args.frames, 5), np.float32)
    path5[:, 0] = 0.05 * np.sin(2 * np.pi * t / 40) \
        + rng.normal(0, 0.008, args.frames)
    path5[:, 1] = 0.04 * np.sin(2 * np.pi * t / 56 + 1.0) \
        + rng.normal(0, 0.008, args.frames)
    still = synthetic.random_still(torch.Generator().manual_seed(11), 256,
                                   320, device=dev)
    clip = synthetic.to_u8(synthetic.jitter_frames(
        still, torch.from_numpy(path5).to(dev))).cpu().numpy()

    def path_rms(x):
        cp = stab_metrics.camera_path(x)
        cp = np.where(np.isnan(cp), 0.0, cp)
        p = np.cumsum(cp[:, :2], axis=0)
        return float(np.sqrt(((p - p.mean(0)) ** 2).mean()))

    print(f"input tracked path RMS: {path_rms(clip):.2f} px")
    for horizon, lag in ((0, 0), (args.horizon, 0),
                         (args.horizon, args.lag)):
        cfg = StabilizeConfig(model=mcfg, chunk_frames=16,
                              path_smooth=horizon, path_smooth_lag=lag)
        out = Stabilizer(cfg, params, device=dev).stabilize_clip(clip)
        label = ("plain" if not horizon else
                 f"path_smooth={horizon}" + (f" lag={lag}" if lag else ""))
        print(f"{label:>24}: tracked path RMS {path_rms(out):.2f} px")
    print("smoothing removes the sway the window-relative model cannot "
          "see; the zero-phase lag mode tracks the path tighter for the "
          "price of --lag frames of output delay (offline runs); pair "
          "with --border-crop auto to hide the larger borders")
    return 0


if __name__ == "__main__":
    sys.exit(main())
