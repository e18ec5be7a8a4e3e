#!/usr/bin/env python
"""Library quickstart (PyTorch port): stabilize an in-memory clip with a
pretrained preset and measure the PSNR gain against ground truth.

Load the weights, feed (T, H, W, 3) uint8 frames, get stabilized frames.
Runs on the CUDA card; ``--device cpu`` runs the same path on the CPU
(the warp kernel's plain version).

    python examples/torch/01_library_quickstart.py [--device cpu]
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
    ap.add_argument("--frames", type=int, default=24)
    args = ap.parse_args()

    import torch

    from dvsg_tpu_torch import resolve_device
    from dvsg_tpu_torch.config import StabilizeConfig
    from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
    from dvsg_tpu_torch.train.eval import evaluate_synthetic
    from dvsg_tpu_torch.train.synthetic import synthetic_clip_u8
    from dvsg_tpu_torch.utils.checkpoint import load_npz

    dev = resolve_device(args.device)
    params, mcfg = load_npz(os.path.join(ROOT, "checkpoints",
                                         "flagship_fast.npz"))
    cfg = StabilizeConfig(model=mcfg, chunk_frames=8)

    # Stabilize any (T, H, W, 3) uint8 array:
    shaky, _, _ = synthetic_clip_u8(torch.Generator().manual_seed(0),
                                    args.frames, 240, 320)
    stab = Stabilizer(cfg, params, device=dev)
    stable = stab.stabilize_clip(shaky.numpy())
    print(f"stabilized {stable.shape[0]} frames "
          f"({stable.shape[2]}x{stable.shape[1]}, dtype {stable.dtype}) "
          f"on {dev}")

    # Score it as train/eval.py does: PSNR against the smoothed-path
    # ground truth (the window-mean camera pose a stabilizer targets).
    metrics = evaluate_synthetic(stab, torch.Generator().manual_seed(1),
                                 args.frames, 240, 320)
    print(f"PSNR vs smoothed-path target: "
          f"{metrics['psnr_identity']:.2f} dB shaky -> "
          f"{metrics['psnr_vs_target']:.2f} dB stabilized "
          f"(gain {metrics['psnr_gain_db']:+.2f} dB, "
          f"stability gain {metrics['stability_gain']:.2f})")


if __name__ == "__main__":
    main()
