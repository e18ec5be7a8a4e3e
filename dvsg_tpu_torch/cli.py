"""Command-line entry point of the PyTorch port.

  python -m dvsg_tpu_torch stabilize --input shaky.mp4 --output stable.mp4
  python -m dvsg_tpu_torch stabilize --input frames/ --output out/ \\
      --preset quality --platform cpu

With no ``--checkpoint``/``--preset`` it uses the committed ``fast``
pretrained model. The flags of the reference CLI that are not ported yet
are accepted by the parser and refused with exit code 2.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_PRESETS = {"fast": "flagship_fast.npz", "quality": "flagship.npz"}
_CHECKPOINT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "checkpoints")

# Reference flags this port refuses for now: (flag, argparse kwargs).
_UNPORTED = (
    ("--path-smooth", dict(type=int)),
    ("--path-smooth-max", dict(type=float)),
    ("--path-smooth-no-rotation", dict(action="store_true", default=None)),
    ("--path-smooth-no-scale", dict(action="store_true", default=None)),
    ("--path-smooth-lag", dict(type=int)),
    ("--path-smooth-conf", dict(type=float)),
    ("--path-smooth-cut", dict(type=float)),
    ("--overlap", dict(action="store_true", default=None)),
    ("--artifact", dict()),
    ("--profile-dir", dict()),
)


def _err(msg: str) -> int:
    print(f"ERROR: {msg}", file=sys.stderr)
    return 2


def _checkpoint_path(args) -> str:
    """--checkpoint wins; else --preset; else the committed fast model."""
    if args.checkpoint:
        return args.checkpoint
    if not args.preset:
        print("no --checkpoint/--preset given; defaulting to the committed "
              "'fast' pretrained model", file=sys.stderr)
    return os.path.join(_CHECKPOINT_DIR, _PRESETS[args.preset or "fast"])


def stabilize_main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dvsg_tpu_torch stabilize",
        description="Stabilize a video file or frame directory (PyTorch "
                    "port; CUDA kernels on the card).")
    p.add_argument("--input", required=True,
                   help="input video file or frame directory")
    p.add_argument("--output", required=True,
                   help="output video file or frame directory")
    p.add_argument("--checkpoint", default=None,
                   help="single-file .npz checkpoint")
    p.add_argument("--preset", choices=tuple(_PRESETS),
                   help="committed pretrained model: 'fast' (128^2 "
                        "encoder) or 'quality' (256^2 encoder)")
    p.add_argument("--chunk-frames", type=int, default=16,
                   help="frames per device step (default 16)")
    p.add_argument("--strength", type=float, default=1.0,
                   help="stabilization strength in [0, 2]: 1 = full "
                        "correction, 0 = passthrough")
    p.add_argument("--border-crop", default="0",
                   help="crop fraction in [0, 0.5) zoomed into the warp "
                        "(hides stabilized borders)")
    p.add_argument("--resume-dir", default=None,
                   help="flush resume state here each chunk; a restart "
                        "resumes at the last flushed chunk (frame-dir "
                        "outputs only)")
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda",
                   help="device to run on (default cuda)")
    for flag, kw in _UNPORTED:
        p.add_argument(flag, help=argparse.SUPPRESS, **kw)
    args = p.parse_args(argv)

    given = [flag for flag, _ in _UNPORTED
             if getattr(args, flag[2:].replace("-", "_")) is not None]
    if given:
        return _err(f"{', '.join(given)}: not ported yet to the PyTorch "
                    "port (use python -m dvsg_tpu.cli)")
    if args.border_crop.strip().lower() == "auto":
        return _err("--border-crop auto: not ported yet; pass a fraction")
    try:
        border_crop = float(args.border_crop)
    except ValueError:
        border_crop = -1.0
    if not 0.0 <= border_crop < 0.5:
        return _err(f"--border-crop must be a fraction in [0, 0.5), got "
                    f"{args.border_crop!r}")
    if not 0.0 <= args.strength <= 2.0:
        return _err("--strength must be in [0, 2]")
    if args.chunk_frames < 1:
        return _err("--chunk-frames must be >= 1")
    if args.checkpoint and args.preset:
        return _err("pass --checkpoint or --preset, not both")
    ckpt = _checkpoint_path(args)
    if not ckpt.endswith(".npz") or not os.path.exists(ckpt):
        return _err(f"checkpoint {ckpt} is not an existing .npz file")

    from dvsg_tpu_torch.utils import video_io
    if args.resume_dir and video_io.is_container_path(args.output):
        # Opening a container writer truncates it: a resumed job would
        # lose its partial output.
        return _err("--resume-dir needs a frame-directory --output")

    from dvsg_tpu_torch.config import StabilizeConfig
    from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
    from dvsg_tpu_torch.utils.checkpoint import load_npz
    from dvsg_tpu_torch.utils.metrics import StageTimer

    params, mcfg = load_npz(ckpt)
    print(f"loaded npz checkpoint {ckpt}", file=sys.stderr)
    cfg = StabilizeConfig(model=mcfg, chunk_frames=args.chunk_frames,
                          border_crop=border_crop, strength=args.strength)
    stab = Stabilizer(cfg, params, device=args.platform)
    reader = video_io.VideoReader(args.input)
    writer = video_io.VideoWriter(args.output, reader.width, reader.height,
                                  reader.fps)
    timer = StageTimer()
    t0 = time.perf_counter()
    try:
        n = stab.stabilize_stream(reader, writer, timer=timer,
                                  resume_dir=args.resume_dir)
    finally:
        reader.close()
        writer.close()
    wall = time.perf_counter() - t0
    fps = n / wall if wall > 0 else 0.0
    print(f"stabilized {n} frames at {reader.width}x{reader.height} on "
          f"{stab.device} in {wall:.2f}s ({fps:.1f} fps)")
    for name, s in timer.summary().items():
        print(f"  {name:8s} total {s['total_s']:7.2f}s  "
              f"mean {s['mean_ms']:7.2f}ms x{s['count']}")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] != "stabilize":
        print("usage: python -m dvsg_tpu_torch stabilize --input IN "
              "--output OUT [options]", file=sys.stderr)
        return 2
    return stabilize_main(argv[1:])
