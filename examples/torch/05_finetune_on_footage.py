#!/usr/bin/env python
"""Fine-tune the PyTorch port on your own footage, then evaluate on it.

The trainer's base imagery can come from your clips instead of procedural
noise; the synthetic jitter and its exact ground truth are unchanged. This
example runs the whole loop end to end with a tiny model:

  1. write a small "user clip" to disk,
  2. build an image bank from it (train/data.py) and train on that bank,
  3. evaluate on a held-out frame of the same clip with
     evaluate_synthetic(still=...).

With a real clip, swap step 1 for your file and raise the steps:

    python -m dvsg_tpu_torch train --checkpoint ckpt/ --steps 4000 \\
        --data myclip.mp4
    python -m dvsg_tpu_torch eval --checkpoint ckpt/

    python examples/torch/05_finetune_on_footage.py [--steps 120]
        [--device cpu]
"""
import argparse
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=120)
    args = ap.parse_args()

    import cv2
    import numpy as np
    import torch

    from dvsg_tpu_torch import resolve_device
    from dvsg_tpu_torch.config import (ModelConfig, StabilizeConfig,
                                       TrainConfig)
    from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
    from dvsg_tpu_torch.train import loop
    from dvsg_tpu_torch.train.data import build_image_bank
    from dvsg_tpu_torch.train.eval import evaluate_synthetic
    from dvsg_tpu_torch.train.synthetic import synthetic_clip_u8
    from dvsg_tpu_torch.utils import video_io

    dev = resolve_device(args.device)

    # 1. A stand-in for "your clip" (any video file or frame dir works).
    work = tempfile.TemporaryDirectory()
    clip = os.path.join(work.name, "mine.mp4")
    frames, _, _ = synthetic_clip_u8(torch.Generator().manual_seed(11), 16,
                                     96, 128)
    with video_io.VideoWriter(clip, 128, 96) as w:
        w.write_batch(frames.numpy())

    # 2. A bank of random crops of the clip -> train on it.
    mcfg = ModelConfig(window=3, model_size=(32, 32), grid_size=(8, 8),
                       base_features=8, blocks_per_level=1,
                       max_offset=0.15)
    bank = build_image_bank(clip, mcfg.model_size, num_images=16)
    print(f"bank: {bank.shape[0]} crops from {os.path.basename(clip)}")
    tcfg = TrainConfig(model=mcfg, batch_size=4, steps=args.steps,
                       warmup_steps=10, learning_rate=1e-3,
                       checkpoint_every=0)
    state = loop.train(tcfg, log_every=max(args.steps // 4, 1), bank=bank,
                       device=dev)

    # 3. Evaluate on a held-out frame of the same footage.
    with video_io.VideoReader(clip) as r:
        held_out = r.read_batch(1000)[-1]
    work.cleanup()
    still = cv2.resize(held_out, (64, 48),
                       interpolation=cv2.INTER_AREA).astype(np.float32) / 255
    stab = Stabilizer(StabilizeConfig(model=mcfg, chunk_frames=8),
                      state.params, device=dev)
    m = evaluate_synthetic(stab, torch.Generator().manual_seed(2), 10, 48,
                           64, still=still)
    print(f"on held-out footage: {m['psnr_identity']:.2f} dB shaky -> "
          f"{m['psnr_vs_target']:.2f} dB stabilized "
          f"(gain {m['psnr_gain_db']:+.2f} dB) on {dev}")


if __name__ == "__main__":
    main()
