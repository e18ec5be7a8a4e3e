#!/usr/bin/env python
"""Streaming (live-source) stabilization with the frame-push API of the
PyTorch port.

``OnlineStabilizer`` serves webcams, RTP feeds and any source that yields
one frame at a time: push frames in, collect stabilized frames as each
device chunk completes. ``--chunk-frames`` trades latency for throughput.

    python examples/torch/02_streaming_online.py [--device cpu]
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
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--chunk-frames", type=int, default=4)
    ap.add_argument("--path-smooth", type=int, default=0,
                    help="EMA horizon of live camera-path smoothing (causal, "
                         "so native to this surface: its (x, y, rotation, "
                         "log-scale) state threads through push/flush)")
    args = ap.parse_args()

    import torch

    from dvsg_tpu_torch import resolve_device
    from dvsg_tpu_torch.config import StabilizeConfig
    from dvsg_tpu_torch.pipeline.online import OnlineStabilizer
    from dvsg_tpu_torch.train.synthetic import synthetic_clip_u8
    from dvsg_tpu_torch.utils.checkpoint import load_npz

    dev = resolve_device(args.device)
    params, mcfg = load_npz(os.path.join(ROOT, "checkpoints",
                                         "flagship_fast.npz"))
    cfg = StabilizeConfig(model=mcfg, chunk_frames=args.chunk_frames,
                          path_smooth=args.path_smooth)

    # Stand-in for a live source: a synthetic shaky clip, frame by frame.
    shaky, _, _ = synthetic_clip_u8(torch.Generator().manual_seed(0),
                                    args.frames, 240, 320)
    source = iter(shaky.numpy())

    stab = OnlineStabilizer(cfg, params, device=dev)
    n_out = 0
    out = None
    for i, frame in enumerate(source):
        for out in stab.push(frame):          # 0 or chunk_frames frames
            n_out += 1
        print(f"pushed frame {i:2d} -> {n_out:2d} stabilized so far")
    for out in stab.flush():                  # drain the partial chunk
        n_out += 1
    print(f"done: {n_out}/{args.frames} stabilized frames "
          f"(shape {out.shape}, dtype {out.dtype}) on {dev}")


if __name__ == "__main__":
    main()
