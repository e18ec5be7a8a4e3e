#!/usr/bin/env python
"""Deployment export with the PyTorch port: write the stabilization chunk
program to a file, then run it from the artifact alone (no model code, no
checkpoint on the serving host).

Build host:   ``export_chunk_program`` traces the chunk step with the
              weights inside into one ``.dvsgt`` file; with
              ``--for-device cuda`` it traces for the card under fake
              tensors, so a build host without a card ships the card's
              artifact (the CLI's ``export --for-platform cuda``).
Serving host: ``load_exported(path)`` and ``.stabilize_clip``: the output
              is byte-identical to the live pipeline
              (tests/test_torch_export.py holds it).

    python examples/torch/06_export_deploy.py [--device cpu]
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
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the serving device, which the artifact is "
                         "exported for")
    ap.add_argument("--for-device", choices=("cuda", "cpu"), default=None,
                    help="export for this device type instead of tracing "
                         "on --device (cuda: no card needed to export)")
    ap.add_argument("--frames", type=int, default=12)
    args = ap.parse_args()

    import torch

    from dvsg_tpu_torch import export as export_lib
    from dvsg_tpu_torch import resolve_device
    from dvsg_tpu_torch.config import StabilizeConfig
    from dvsg_tpu_torch.train.synthetic import synthetic_clip_u8
    from dvsg_tpu_torch.utils.checkpoint import load_npz

    dev = resolve_device(args.device)
    params, mcfg = load_npz(os.path.join(ROOT, "checkpoints",
                                         "flagship_fast.npz"))
    h, w = 240, 320
    cfg = StabilizeConfig(model=mcfg, chunk_frames=8)

    # --- build host: one call, one file ---------------------------------
    work = tempfile.TemporaryDirectory()
    path = os.path.join(work.name, "flagship_fast_240p.dvsgt")
    exp = export_lib.export_chunk_program(cfg, params, h, w, device=dev,
                                          for_device=args.for_device)
    export_lib.save_exported(exp, path, cfg)
    print(f"exported -> {path} ({os.path.getsize(path) / 1e6:.1f} MB, "
          f"for {exp.device})")

    # --- serving host: the artifact only --------------------------------
    loaded = export_lib.load_exported(path, device=dev)
    work.cleanup()
    shaky, _, _ = synthetic_clip_u8(torch.Generator().manual_seed(0),
                                    args.frames, h, w)
    out = loaded.stabilize_clip(shaky.numpy())
    print(f"stabilized {out.shape[0]} frames from the artifact "
          f"(T={loaded.chunk_frames}, {loaded.width}x{loaded.height}, "
          f"{loaded.device})")


if __name__ == "__main__":
    main()
