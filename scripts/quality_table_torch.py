#!/usr/bin/env python
"""No-ground-truth quality table of the PyTorch port: the literature trio
on real-ish clips.

The counterpart of scripts/quality_table.py on ``dvsg_tpu_torch``. It runs
the stability / cropping-ratio / distortion-value protocol
(dvsg_tpu_torch/utils/stab_metrics.py: LK feature tracking and robust
similarity fits, so the measurement applies to real footage) over four
fixtures, with and without path smoothing, and prints a markdown table.
The regression gates are in tests/test_torch_quality_table.py.

Fixtures (multi-octave texture LK can track, 64 frames, 256x320), the
reference's clips rendered with the port's train/synthetic.py: from the
reference's ``jax.random`` draws, committed in quality_fixture_draws.npz
(scripts/quality_fixture_draws.py writes them; the gates hold on those
clips, not on other draws of the same distributions), and its numpy sway
paths:
  sway      translation sway (periods 40 and 56 frames) + white jitter
  rot-sway  + rotation sway (period 48)
  zoom-sway + log-scale sway (period 48)
  handheld  the full 5-parameter random handheld walk

Run: python scripts/quality_table_torch.py [--json out.json]
     [--device cuda|cpu] (default cuda; no card and no --device cpu is an
     error)
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

FIXTURES = ("sway", "rot-sway", "zoom-sway", "handheld")


DRAWS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "quality_fixture_draws.npz")
T_N, H, W = 64, 256, 320


def make_fixture(name, device="cpu"):
    """Fixture ``name`` as (64, 256, 320, 3) uint8 numpy frames, rendered on
    ``device``."""
    import numpy as np
    import torch

    from dvsg_tpu_torch import resolve_device
    from dvsg_tpu_torch.ops import grid as grid_ops
    from dvsg_tpu_torch.ops import warp as warp_ops
    from dvsg_tpu_torch.train import synthetic

    if name not in FIXTURES:
        raise ValueError(f"unknown fixture {name!r}; one of {FIXTURES}")
    dev = resolve_device(device)
    with np.load(DRAWS) as d:
        draws = {k: torch.from_numpy(d[k]).to(dev) for k in d.files}
    t = np.arange(T_N)
    rng = np.random.default_rng(3)
    still = synthetic.still_from_octaves(
        [draws[f"still_octave{i}"] for i in range(4)], H, W)
    if name == "handheld":
        path = synthetic.camera_path_from_draws(
            draws["handheld_steps"], draws["handheld_mag"], max_trans=0.05,
            max_angle=0.03, max_persp=0.01)
        frames = synthetic.jitter_frames(still, path)
    elif name == "zoom-sway":
        path4 = np.zeros((T_N, 4), np.float32)
        path4[:, 0] = 0.03 * np.sin(2 * np.pi * t / 40) \
            + rng.normal(0, 0.008, T_N)
        path4[:, 1] = 0.03 * np.sin(2 * np.pi * t / 56 + 1.0) \
            + rng.normal(0, 0.008, T_N)
        path4[:, 3] = 0.04 * np.sin(2 * np.pi * t / 48 + 0.5) \
            + rng.normal(0, 0.004, T_N)
        grids = grid_ops.homography_grid(synthetic.similarity_theta(
            torch.from_numpy(path4).to(dev)), H, W)
        frames = warp_ops.warp_batch(
            still[None].expand(T_N, -1, -1, -1).contiguous(), grids)
    else:
        path5 = np.zeros((T_N, 5), np.float32)
        path5[:, 0] = 0.05 * np.sin(2 * np.pi * t / 40) \
            + rng.normal(0, 0.008, T_N)
        path5[:, 1] = 0.04 * np.sin(2 * np.pi * t / 56 + 1.0) \
            + rng.normal(0, 0.008, T_N)
        if name == "rot-sway":
            path5[:, 2] = 0.05 * np.sin(2 * np.pi * t / 48 + 0.5) \
                + rng.normal(0, 0.004, T_N)
        frames = synthetic.jitter_frames(still,
                                         torch.from_numpy(path5).to(dev))
    return synthetic.to_u8(frames).cpu().numpy()


def _path_rms(frames):
    """RMS of the tracked cumulative translation path, pixels."""
    import numpy as np

    from dvsg_tpu_torch.utils import stab_metrics
    cp = stab_metrics.camera_path(frames)
    cp = np.where(np.isnan(cp), 0.0, cp)
    p = np.cumsum(cp[:, :2], axis=0)
    return float(np.sqrt(((p - p.mean(0)) ** 2).mean()))


def measure(name, clip, params, mcfg, horizon, device="cuda"):
    """The table's row of ``clip`` (uint8 numpy frames): the port's
    ``Stabilizer`` on ``device``, plain and with ``path_smooth=horizon``."""
    from dvsg_tpu_torch.config import StabilizeConfig
    from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
    from dvsg_tpu_torch.utils import stab_metrics

    row = {"fixture": name}
    for tag, smooth in (("plain", 0), ("smooth", horizon)):
        cfg = StabilizeConfig(model=mcfg, chunk_frames=16,
                              path_smooth=smooth)
        out = Stabilizer(cfg, params, device=device).stabilize_clip(clip)
        rep = stab_metrics.stability_report(clip, out)
        row[f"stability_{tag}"] = round(rep["stability_out"], 4)
        row[f"crop_{tag}"] = round(rep["cropping_ratio"], 4)
        row[f"distortion_{tag}"] = round(rep["distortion_value"], 4)
        if tag == "plain":
            row["stability_in"] = round(rep["stability_in"], 4)
        row[f"t_rms_{tag}"] = round(_path_rms(out), 3)
    row["t_rms_in"] = round(_path_rms(clip), 3)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--horizon", type=int, default=32)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from dvsg_tpu_torch import resolve_device
    from dvsg_tpu_torch.utils import checkpoint as ckpt
    dev = resolve_device(args.device)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    params, mcfg = ckpt.load_npz(
        os.path.join(root, "checkpoints", "flagship_fast.npz"))

    rows = []
    for name in FIXTURES:
        row = measure(name, make_fixture(name, device=dev), params, mcfg,
                      args.horizon, device=dev)
        rows.append(row)
        print(f"{name}: {row}", flush=True)

    cols = ["fixture", "t_rms_in", "t_rms_plain", "t_rms_smooth",
            "stability_in", "stability_plain", "stability_smooth",
            "crop_plain", "crop_smooth", "distortion_plain",
            "distortion_smooth"]
    print(f"\ndevice: {dev}")
    print("| " + " | ".join(cols) + " |")
    print("|" + "---|" * len(cols))
    for r in rows:
        print("| " + " | ".join(str(r.get(c, "")) for c in cols) + " |")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": str(dev), "rows": rows}, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
