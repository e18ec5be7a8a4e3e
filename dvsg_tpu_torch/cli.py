"""Command-line entry point of the PyTorch port.

  python -m dvsg_tpu_torch stabilize --input shaky.mp4 --output stable.mp4
  python -m dvsg_tpu_torch stabilize --input frames/ --output out/ \\
      --preset quality --platform cpu
  python -m dvsg_tpu_torch train --checkpoint ckpt/ --steps 1000
  python -m dvsg_tpu_torch eval --checkpoint ckpt/ --clips 3

Every command runs on the CUDA card unless ``--platform cpu`` is given.
With no ``--checkpoint``/``--preset``, ``stabilize`` and ``eval`` use the
committed ``fast`` pretrained model. The flags of the reference CLI that
are not ported yet are accepted by the parser and refused with exit code 2.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

_PRESETS = {"fast": "flagship_fast.npz", "quality": "flagship.npz"}
_CHECKPOINT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "checkpoints")

# Reference flags this port refuses for now: (flag, argparse kwargs).
_UNPORTED_SMOOTH = (
    ("--path-smooth", dict(type=int)),
    ("--path-smooth-max", dict(type=float)),
    ("--path-smooth-no-rotation", dict(action="store_true", default=None)),
    ("--path-smooth-no-scale", dict(action="store_true", default=None)),
    ("--path-smooth-lag", dict(type=int)),
    ("--path-smooth-conf", dict(type=float)),
    ("--path-smooth-cut", dict(type=float)),
)
_UNPORTED = _UNPORTED_SMOOTH + (
    ("--overlap", dict(action="store_true", default=None)),
    ("--artifact", dict()),
    ("--profile-dir", dict()),
)


def _err(msg: str) -> int:
    print(f"ERROR: {msg}", file=sys.stderr)
    return 2


def _add_unported(p: argparse.ArgumentParser, flags) -> None:
    for flag, kw in flags:
        p.add_argument(flag, help=argparse.SUPPRESS, **kw)


def _refused(args, flags) -> list:
    """The unported flags the caller gave."""
    return [flag for flag, _ in flags
            if getattr(args, flag[2:].replace("-", "_")) is not None]


# ModelConfig-matching defaults; the parser uses None sentinels so a run can
# tell "custom architecture asked for" from "no model flags at all".
_MODEL_ARG_DEFAULTS = {"window": 5, "model_size": (256, 256),
                       "grid_size": (16, 16), "dtype": "float32"}


def _add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--window", type=int, default=None,
                   help="temporal window length N (default 5)")
    p.add_argument("--model-size", type=int, nargs=2, default=None,
                   metavar=("H", "W"),
                   help="CNN input resolution (default 256 256)")
    p.add_argument("--grid-size", type=int, nargs=2, default=None,
                   metavar=("GH", "GW"),
                   help="coarse control grid (default 16 16)")
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   default=None, help="CNN compute dtype (default float32; "
                                      "bfloat16 is not ported yet)")


def _model_cfg(args):
    from dvsg_tpu_torch.config import ModelConfig
    d = {k: v if (v := getattr(args, k, None)) is not None else dflt
         for k, dflt in _MODEL_ARG_DEFAULTS.items()}
    return ModelConfig(window=d["window"],
                       model_size=tuple(d["model_size"]),
                       grid_size=tuple(d["grid_size"]), dtype=d["dtype"])


def _custom_arch(args) -> bool:
    return any(getattr(args, k, None) is not None
               for k in _MODEL_ARG_DEFAULTS if k != "dtype")


def _load_any_checkpoint(path: str):
    """(state dict, ModelConfig) from a training checkpoint directory or a
    single-file .npz."""
    from dvsg_tpu_torch.utils import checkpoint as ckpt
    if path.endswith(".npz"):
        params, mcfg = ckpt.load_npz(path)
        print(f"loaded npz checkpoint {path}", file=sys.stderr)
    else:
        params, mcfg, step = ckpt.load_checkpoint(path)
        print(f"loaded checkpoint step {step} from {path}", file=sys.stderr)
    return params, mcfg


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
    _add_unported(p, _UNPORTED)
    args = p.parse_args(argv)

    given = _refused(args, _UNPORTED)
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


def train_main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dvsg_tpu_torch train",
        description="Self-supervised training on synthetic-jitter clips.")
    p.add_argument("--checkpoint", required=True, help="checkpoint out dir")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=2e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda",
                   help="device to run on (default cuda)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest step in --checkpoint")
    p.add_argument("--data", nargs="+", default=None, metavar="CLIP",
                   help="fine-tune on your own footage: video files or "
                        "frame dirs used as the base-image bank "
                        "(supervision stays the exact synthetic jitter)")
    p.add_argument("--data-images", type=int, default=256,
                   help="bank size when --data is given (random crops)")
    _add_model_args(p)
    args = p.parse_args(argv)
    if args.dtype not in (None, "float32"):
        return _err(f"--dtype {args.dtype}: not ported yet (float32 only)")

    import torch

    from dvsg_tpu_torch import resolve_device
    from dvsg_tpu_torch.config import TrainConfig
    from dvsg_tpu_torch.train import loop

    device = resolve_device(args.platform)
    cfg = TrainConfig(model=_model_cfg(args), steps=args.steps,
                      batch_size=args.batch_size,
                      learning_rate=args.learning_rate, seed=args.seed)
    bank = None
    if args.data:
        from dvsg_tpu_torch.train.data import build_image_bank_multi
        bank = build_image_bank_multi(args.data, cfg.model.model_size,
                                      num_images=args.data_images,
                                      seed=args.seed)
        print(f"image bank: {bank.shape[0]} crops from "
              f"{len(args.data)} clip(s)")
    state = None
    if args.resume:
        try:
            state = loop.load_train_state(cfg, args.checkpoint,
                                          device=device)
        except ValueError as e:
            return _err(f"--resume: {e}")
        print(f"resuming from step {state.step}")
    loop.train(cfg, checkpoint_dir=args.checkpoint, state=state, bank=bank,
               device=device)
    print(f"saved checkpoint to {args.checkpoint} (trained on {device}, "
          f"torch {torch.__version__})")
    return 0


def eval_main(argv=None) -> int:
    """Evaluate stabilization quality on synthetic-jitter ground truth."""
    p = argparse.ArgumentParser(
        prog="python -m dvsg_tpu_torch eval",
        description="Evaluate a checkpoint on synthetic shaky clips.")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir or .npz; the committed fast model "
                        "if omitted (an untrained identity model if model "
                        "flags are given)")
    p.add_argument("--preset", choices=tuple(_PRESETS),
                   help="committed pretrained model: 'fast' or 'quality'")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--size", type=int, nargs=2, default=(480, 640),
                   metavar=("H", "W"))
    p.add_argument("--clips", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk-frames", type=int, default=16,
                   help="frames per device step (default 16)")
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda",
                   help="device to run on (default cuda)")
    p.add_argument("--metrics-out", default=None)
    p.add_argument("--track-metrics", action="store_true",
                   help="also report the feature-tracking stabilization "
                        "trio (stability score, cropping ratio, "
                        "distortion value) — no ground truth needed, "
                        "host-side cv2 work")
    p.add_argument("--stills", default=None, metavar="CLIP",
                   help="evaluate on YOUR imagery: a video/frame dir whose "
                        "frames become the base images (resized to --size, "
                        "one per clip, cycled), jittered with the exact "
                        "synthetic ground truth instead of procedural "
                        "textures")
    _add_model_args(p)
    _add_unported(p, _UNPORTED_SMOOTH)
    args = p.parse_args(argv)
    given = _refused(args, _UNPORTED_SMOOTH)
    if given:
        return _err(f"{', '.join(given)}: not ported yet to the PyTorch "
                    "port (use python -m dvsg_tpu.cli)")
    if args.dtype not in (None, "float32"):
        return _err(f"--dtype {args.dtype}: not ported yet (float32 only)")
    if args.checkpoint and args.preset:
        return _err("pass --checkpoint or --preset, not both")
    if args.chunk_frames < 1:
        return _err("--chunk-frames must be >= 1")

    import torch

    from dvsg_tpu_torch.config import StabilizeConfig
    from dvsg_tpu_torch.models import motion_cnn
    from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
    from dvsg_tpu_torch.train.eval import evaluate_synthetic
    from dvsg_tpu_torch.utils.metrics import write_metrics_jsonl

    if args.checkpoint or args.preset or not _custom_arch(args):
        path = _checkpoint_path(args)
        if not os.path.exists(path):
            return _err(f"checkpoint {path} does not exist")
        params, mcfg = _load_any_checkpoint(path)
    else:
        mcfg = _model_cfg(args)
        params = motion_cnn.init_params(mcfg,
                                        torch.Generator().manual_seed(0))
        print("WARNING: evaluating an untrained (identity) model",
              file=sys.stderr)

    h, w = args.size
    cfg = StabilizeConfig(model=mcfg, chunk_frames=args.chunk_frames)
    stab = Stabilizer(cfg, params, device=args.platform)
    stills = None
    if args.stills:
        import cv2
        from dvsg_tpu_torch.train.data import iter_sampled_frames
        # Streaming sampler: only the --clips sampled frames are decoded.
        try:
            stills = []
            for frame, cnt in iter_sampled_frames(args.stills, args.clips):
                still = cv2.resize(frame, (w, h),
                                   interpolation=cv2.INTER_AREA
                                   ).astype(np.float32) / 255.0
                stills.extend([still] * cnt)
        except (ValueError, OSError):
            stills = []
        if not stills:
            return _err(f"no frames in {args.stills}")
        while len(stills) < args.clips:  # overcounted container metadata
            stills.append(stills[-1])
    agg = {}
    for i in range(args.clips):
        m = evaluate_synthetic(
            stab, torch.Generator().manual_seed(args.seed + i),
            args.frames, h, w, track_metrics=args.track_metrics,
            still=None if stills is None else stills[i])
        print(f"clip {i}: " + "  ".join(f"{k}={v:.3f}"
                                        for k, v in m.items()))
        for k, v in m.items():
            agg.setdefault(k, []).append(v)
    # nanmean: a clip whose feature tracking failed reports NaN for the
    # tracking trio — it must not poison the other clips' aggregate.
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN slice
        mean = {k: float(np.nanmean(v)) for k, v in agg.items()}
    print("mean:   " + "  ".join(f"{k}={v:.3f}" for k, v in mean.items()))
    if args.metrics_out:
        # NaN -> null: keep the JSONL strictly parseable.
        write_metrics_jsonl(args.metrics_out, {
            "kind": "eval_synthetic", "device": str(stab.device),
            **{k: (None if np.isnan(v) else v) for k, v in mean.items()}})
    return 0


_COMMANDS = {"stabilize": stabilize_main, "train": train_main,
             "eval": eval_main}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in _COMMANDS:
        print("usage: python -m dvsg_tpu_torch {stabilize,train,eval} "
              "[options]", file=sys.stderr)
        return 2
    return _COMMANDS[argv[0]](argv[1:])
