"""Command-line entry point of the PyTorch port.

  python -m dvsg_tpu_torch stabilize --input shaky.mp4 --output stable.mp4
  python -m dvsg_tpu_torch stabilize --input frames/ --output out/ \\
      --preset quality --platform cpu
  python -m dvsg_tpu_torch stabilize-batch --inputs a.mp4 b.mp4 \\
      --outputs a_out.mp4 b_out.mp4
  torchrun --nproc-per-node 4 -m dvsg_tpu_torch stabilize-batch \\
      --inputs a.mp4 b.mp4 c.mp4 d.mp4 --outputs ...   (one clip per card)
  python -m dvsg_tpu_torch export --preset fast --size 720 1280 \\
      --output fast_720p.dvsgt
  python -m dvsg_tpu_torch export --preset fast --size 720 1280 \\
      --for-platform cuda --output fast_720p.dvsgt   (on a host without a card)
  python -m dvsg_tpu_torch stabilize --artifact fast_720p.dvsgt \\
      --input shaky.mp4 --output stable.mp4
  python -m dvsg_tpu_torch train --checkpoint ckpt/ --steps 1000
  python -m dvsg_tpu_torch eval --checkpoint ckpt/ --clips 3
  python -m dvsg_tpu_torch stabilize --input in/ --output out/ \\
      --path-smooth 32 --path-smooth-lag 16 --border-crop auto
  python -m dvsg_tpu_torch.serve --preset fast --port 8799   (HTTP server)

Every command runs on the CUDA card unless ``--platform cpu`` is given.
With no ``--checkpoint``/``--preset`` and no model flags, ``stabilize``,
``stabilize-batch`` and ``eval`` use the committed ``fast`` pretrained
model; model flags without a checkpoint select an untrained (identity)
model. ``--checkpoint`` takes a training checkpoint directory or an
``.npz``. ``--dtype bfloat16`` runs the CNN's trunk in bf16 (its heads stay
f32); on a loaded checkpoint it re-applies onto the checkpoint's config,
and it is no architecture flag (the committed weights run in either
dtype). ``stabilize --profile-dir DIR`` writes a ``torch.profiler`` trace
of the run there and prints its top ops, its stages' spans and the
device's idle share (utils/profiling.py). ``export`` writes the port's own artifact
(export.py), which ``stabilize --artifact`` runs. ``--warp-impl
pallas|lax`` is refused with exit code 2: the port has one warp route.
As in the reference, ``--checkpoint`` wins over ``--preset``, and
``--chunk-frames 0`` (or none) picks T: the port's T = 16 at every
resolution.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time
from typing import Optional

import numpy as np

_PRESETS = {"fast": "flagship_fast.npz", "quality": "flagship.npz"}
AUTO_CHUNK_FRAMES = 16
_CHECKPOINT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "checkpoints")

def _err(msg: str) -> int:
    print(f"ERROR: {msg}", file=sys.stderr)
    return 2


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
                   default=None, help="CNN compute dtype (default float32)")


def _model_cfg(args):
    from dvsg_tpu_torch.config import ModelConfig
    d = {k: v if (v := getattr(args, k, None)) is not None else dflt
         for k, dflt in _MODEL_ARG_DEFAULTS.items()}
    return ModelConfig(window=d["window"],
                       model_size=tuple(d["model_size"]),
                       grid_size=tuple(d["grid_size"]), dtype=d["dtype"])


def _custom_arch(args) -> bool:
    # --dtype is a compute knob, not architecture: it never invalidates
    # checkpoint weights (it is re-applied onto any loaded config instead).
    return any(getattr(args, k, None) is not None
               for k in _MODEL_ARG_DEFAULTS if k != "dtype")


def _apply_dtype(mcfg, args):
    """Fold an explicit --dtype onto a loaded checkpoint's config."""
    if getattr(args, "dtype", None) and args.dtype != mcfg.dtype:
        import dataclasses
        mcfg = dataclasses.replace(mcfg, dtype=args.dtype)
    return mcfg


def _load_any_checkpoint(path: str):
    """(state dict, ModelConfig) from a training checkpoint directory or a
    single-file .npz. A missing one raises ``FileNotFoundError`` naming
    the file the reference names (the directory's config sidecar)."""
    from dvsg_tpu_torch.utils import checkpoint as ckpt
    if path.endswith(".npz"):
        params, mcfg = ckpt.load_npz(path)
        print(f"loaded npz checkpoint {path}")
    else:
        params, mcfg, step = ckpt.load_checkpoint(path)
        print(f"loaded checkpoint step {step} from {path}")
    return params, mcfg


def _checkpoint_path(args) -> str:
    """--checkpoint wins; else --preset; else the committed fast model."""
    if args.checkpoint:
        return args.checkpoint
    if not args.preset:
        print("no --checkpoint/--preset given; defaulting to the committed "
              "'fast' pretrained model", file=sys.stderr)
    return os.path.join(_CHECKPOINT_DIR, _PRESETS[args.preset or "fast"])


def _load_model(args):
    """(state dict, ModelConfig) that a command's flags select: the
    --checkpoint (directory or .npz), else the --preset, else with model
    flags an untrained identity model, else the committed fast model.
    A missing checkpoint raises ``FileNotFoundError``."""
    if args.checkpoint or args.preset or not _custom_arch(args):
        params, mcfg = _load_any_checkpoint(_checkpoint_path(args))
        return params, _apply_dtype(mcfg, args)
    import torch
    from dvsg_tpu_torch.models import motion_cnn
    mcfg = _model_cfg(args)
    params = motion_cnn.init_params(mcfg, torch.Generator().manual_seed(0))
    print("WARNING: no --checkpoint given; using an untrained (identity) "
          "model", file=sys.stderr)
    return params, mcfg


def _chunk_frames(args) -> Optional[int]:
    """The chunk size ``--chunk-frames`` asks for (0 or none: the auto pick,
    ``AUTO_CHUNK_FRAMES``), or None after printing why it is refused."""
    if args.chunk_frames is not None and args.chunk_frames < 0:
        _err("--chunk-frames must be >= 1 (or 0 for the auto pick)")
        return None
    return args.chunk_frames or AUTO_CHUNK_FRAMES


def _auto_chunk_notice(args, height: int, width: int,
                       n_clips: int = 1) -> None:
    """The reference's notice that T was picked, printed where it was."""
    if not args.chunk_frames:
        extra = f" x{n_clips} clips" if n_clips > 1 else ""
        print(f"--chunk-frames not given; auto-picked T={AUTO_CHUNK_FRAMES} "
              f"for {width}x{height}{extra} ({args.platform} sweep)",
              file=sys.stderr)


def _add_warp_impl_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--warp-impl", choices=("auto", "pallas", "lax"),
                   default=None,
                   help="accepted for the reference CLI's sake: 'auto' is "
                        "the port's one warp route (the CUDA kernel on the "
                        "card, its plain version on the CPU)")


def _bad_warp_impl(warp_impl: str) -> bool:
    """Refuse a warp route the port does not have (printing why)."""
    if warp_impl in (None, "auto"):
        return False
    _err(f"--warp-impl {warp_impl}: the port has one warp route, the CUDA "
         "kernel on the card and its plain version on the CPU (--platform "
         "cpu); drop --warp-impl")
    return True


def _parse_border_crop(val):
    """'auto', a float in [0, 0.5), or None (parse error, message
    printed)."""
    s = str(val).strip().lower()
    if s == "auto":
        return "auto"
    try:
        f = float(s)
    except ValueError:
        f = -1.0
    if not 0.0 <= f < 0.5:
        _err(f"--border-crop must be a fraction in [0, 0.5) or 'auto', got "
             f"{val!r}")
        return None
    return f


def _add_smooth_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--path-smooth", type=int, default=0, metavar="FRAMES",
                   help="camera-path smoothing horizon in frames (0 = "
                        "off): removes the slow sway the model's short "
                        "window passes through, with an EMA over the "
                        "measured camera path; try 32")
    p.add_argument("--path-smooth-max", type=float, default=0.05,
                   help="clamp on the smoothing correction per frame and "
                        "component (default 0.05)")
    p.add_argument("--path-smooth-no-rotation", action="store_true",
                   help="do not measure or smooth rotation sway")
    p.add_argument("--path-smooth-no-scale", action="store_true",
                   help="do not measure or smooth zoom sway")
    p.add_argument("--path-smooth-lag", type=int, default=0, metavar="D",
                   help="fixed-lag smoothing: delay the output D frames and "
                        "smooth with a zero-phase filter over the D-frame "
                        "lookahead (not with --overlap); try half of "
                        "--path-smooth")
    p.add_argument("--path-smooth-conf", type=float, default=2.0,
                   help="confidence gate on the path measurement (peak-to-"
                        "second-peak ratio); deltas below it are zeroed; 0 "
                        "disables (default 2.0)")
    p.add_argument("--path-smooth-cut", type=float, default=1.5,
                   help="scene-cut gate (<= --path-smooth-conf): below it "
                        "the smoother restarts; 0 disables (default 1.5)")


def _smooth_kwargs(args) -> dict:
    return dict(path_smooth=args.path_smooth,
                path_smooth_max=args.path_smooth_max,
                path_smooth_rotation=not args.path_smooth_no_rotation,
                path_smooth_scale=not args.path_smooth_no_scale,
                path_smooth_lag=args.path_smooth_lag,
                path_smooth_conf=args.path_smooth_conf,
                path_smooth_cut=args.path_smooth_cut)


def _run_autocrop_scan(cfg, params, input_paths, device) -> float:
    """Pass 1 of --border-crop auto: scan the input(s) with fresh readers
    (several in lockstep, sharing one crop), report on stderr, and return
    the picked crop fraction."""
    from dvsg_tpu_torch.pipeline import autocrop
    from dvsg_tpu_torch.utils import video_io
    t0 = time.perf_counter()
    readers = [video_io.VideoReader(p_) for p_ in input_paths]
    try:
        m = autocrop.scan_readers_max_offset(cfg, params, readers, device)
    finally:
        for r in readers:
            r.close()
    # The smoothing stage adds up to this much beyond the scanned offsets.
    m += autocrop.smoothing_margin(cfg)
    crop, capped = autocrop.crop_for_max_offset(m)
    extra = (f" (shared over {len(input_paths)} clips)"
             if len(input_paths) > 1 else "")
    print(f"auto border-crop{extra}: max |offset| {m:.4f} -> crop "
          f"{crop:.4f} ({round(crop * autocrop.CROP_DENOM)}/"
          f"{autocrop.CROP_DENOM}, scan {time.perf_counter() - t0:.1f}s)",
          file=sys.stderr)
    if capped:
        print("WARNING: clip motion exceeds the largest valid crop "
              "(31/64); residual borders will be edge-clamped",
              file=sys.stderr)
    return crop


def _add_common_args(p: argparse.ArgumentParser) -> None:
    """Flags the stabilize commands share."""
    p.add_argument("--checkpoint", default=None,
                   help="training checkpoint directory (from train) or "
                        ".npz; the committed fast model if omitted (an "
                        "untrained identity model if model flags are given)")
    p.add_argument("--preset", choices=tuple(_PRESETS),
                   help="committed pretrained model: 'fast' (128^2 "
                        "encoder) or 'quality' (256^2 encoder)")
    # None sentinels: an --artifact run refuses what was baked at export.
    p.add_argument("--chunk-frames", type=int, default=None,
                   help="frames per device step (default or 0: the auto "
                        "pick, 16)")
    p.add_argument("--strength", type=float, default=None,
                   help="stabilization strength in [0, 2]: 1 = full "
                        "correction, 0 = passthrough")
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda",
                   help="device to run on (default cuda)")
    p.add_argument("--metrics-out", default=None,
                   help="append a JSONL metrics record here")
    _add_warp_impl_arg(p)
    _add_smooth_args(p)
    _add_model_args(p)


def _check_common(args):
    """(params, ModelConfig, border crop or 'auto', chunk frames), or None
    after printing why the flags are refused."""
    if args.strength is None:
        args.strength = 1.0
    if _bad_warp_impl(args.warp_impl):
        return None
    border_crop = _parse_border_crop(args.border_crop)
    if border_crop is None:
        return None
    if not 0.0 <= args.strength <= 2.0:
        _err("--strength must be in [0, 2]")
        return None
    chunk = _chunk_frames(args)
    if chunk is None:
        return None
    return (*_load_model(args), border_crop, chunk)


def _print_stages(timer) -> None:
    for name, s in timer.summary().items():
        print(f"  {name:12s} total {s['total_s']:7.2f}s  "
              f"mean {s['mean_ms']:7.2f}ms x{s['count']}")


def stabilize_main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dvsg_tpu_torch stabilize",
        description="Stabilize a video file or frame directory (PyTorch "
                    "port; CUDA kernels on the card).")
    p.add_argument("--input", required=True,
                   help="input video file or frame directory")
    p.add_argument("--output", required=True,
                   help="output video file or frame directory")
    p.add_argument("--border-crop", default="0",
                   help="crop fraction in [0, 0.5) zoomed into the warp "
                        "(hides stabilized borders), or 'auto': a "
                        "predict-only first pass over the input picks the "
                        "smallest crop that hides every border")
    p.add_argument("--resume-dir", default=None,
                   help="flush resume state here each chunk; a restart "
                        "resumes at the last flushed chunk (frame-dir "
                        "outputs only)")
    p.add_argument("--overlap", action="store_true",
                   help="overlap decode, compute and encode (threads, "
                        "pinned buffers, a copy stream); no --resume-dir, "
                        "no --path-smooth-lag")
    p.add_argument("--artifact", default=None,
                   help="run an exported program (python -m dvsg_tpu_torch "
                        "export) instead of a checkpoint: weights, chunk "
                        "size, strength, crop and smoothing are baked in")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of the stream loop "
                        "into this dir and print an op summary and the "
                        "device's idle share")
    _add_common_args(p)
    args = p.parse_args(argv)

    if args.overlap and args.resume_dir:
        return _err("--overlap has no resume support; drop --overlap for a "
                    "resumable run (or --resume-dir for an overlapped one)")
    from dvsg_tpu_torch.utils import video_io
    if args.resume_dir and video_io.is_container_path(args.output):
        # Opening a container writer truncates it: a resumed job would
        # lose its partial output.
        return _err("--resume-dir needs a frame-directory --output")

    from dvsg_tpu_torch.config import StabilizeConfig
    from dvsg_tpu_torch.pipeline import pathsmooth
    from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
    from dvsg_tpu_torch.utils import profiling
    from dvsg_tpu_torch.utils.metrics import StageTimer, write_metrics_jsonl

    if args.artifact:
        loaded = _load_artifact(args)
        if loaded is None:
            return 2
        cfg = loaded.cfg
    else:
        checked = _check_common(args)
        if checked is None:
            return 2
        params, mcfg, border_crop, chunk = checked
        try:
            cfg = StabilizeConfig(model=mcfg, chunk_frames=chunk,
                                  strength=args.strength,
                                  **_smooth_kwargs(args))
            if args.overlap:
                pathsmooth.lag_reject(cfg, "--overlap (drop --overlap for a "
                                      "lag run)")
        except ValueError as e:
            return _err(str(e))
        if border_crop == "auto":
            # Pass 1 shares chunking, strength and the smoothing margin
            # with pass 2, so both passes predict the same offsets.
            border_crop = _run_autocrop_scan(cfg, params, [args.input],
                                             args.platform)
        cfg = cfg.replace(border_crop=border_crop)
        stab = Stabilizer(cfg, params, device=args.platform)
    reader = video_io.VideoReader(args.input)
    if args.artifact:
        if (reader.height, reader.width) != (loaded.height, loaded.width):
            reader.close()
            return _err(f"artifact was exported for {loaded.width}x"
                        f"{loaded.height}; input is {reader.width}x"
                        f"{reader.height} (export again with --size, or "
                        "stabilize from a checkpoint)")
        stab = loaded.engine()
    else:
        _auto_chunk_notice(args, reader.height, reader.width)
    writer = video_io.VideoWriter(args.output, reader.width, reader.height,
                                  reader.fps)
    timer = StageTimer()
    t0 = time.perf_counter()
    try:
        with profiling.trace(args.profile_dir, stab.device):
            if args.overlap:
                from dvsg_tpu_torch.pipeline.overlap import (
                    stabilize_stream_overlapped)
                n = stabilize_stream_overlapped(stab, reader, writer,
                                                timer=timer)
            else:
                n = stab.stabilize_stream(reader, writer, timer=timer,
                                          resume_dir=args.resume_dir)
    finally:
        reader.close()
        writer.close()
    wall = time.perf_counter() - t0
    if args.profile_dir:
        _print_profile(args.profile_dir)
    fps = n / wall if wall > 0 else 0.0
    print(f"stabilized {n} frames at {reader.width}x{reader.height} on "
          f"{stab.device} in {wall:.2f}s ({fps:.1f} fps)")
    _print_stages(timer)
    if args.metrics_out:
        write_metrics_jsonl(args.metrics_out, {
            "kind": "stabilize", "frames": n, "wall_s": wall, "fps": fps,
            "width": reader.width, "height": reader.height,
            "device": str(stab.device), "stages": timer.summary(),
            "coverage_fallback_chunks": stab.coverage_fallbacks,
            "chunks": stab.chunks_seen})
    return 0


def _print_profile(trace_dir: str) -> None:
    """The reference's ``[profile]`` lines: the eight ops of the largest
    total time, then the fused warp (B1) where it is not among them; then
    one line per span of the program (its count, host time and, on a
    card, the device's idle time while it was open) and the device's busy,
    NCCL and idle shares of the profiled window (a card's trace only)."""
    from dvsg_tpu_torch.utils import profiling
    summary = profiling.summarize_trace(trace_dir)
    names = list(summary)[:8]
    names += [n for n in summary if "warp_u8_offsets" in n
              and n not in names]
    for name in names:
        rec = summary[name]
        print(f"  [profile] {rec['mean_ms']:8.2f} ms x{rec['count']:3d} "
              f"{name[:60]}")
    for name, rec in profiling.span_stats(trace_dir).items():
        idle = ("" if rec["idle_ms"] is None
                else f", device idle {rec['idle_ms']:.2f} ms")
        print(f"  [profile] span {name} x{rec['count']}: host "
              f"{rec['host_ms']:.2f} ms{idle}")
    busy = profiling.device_busy_stats(trace_dir)
    if busy is not None:
        print(f"  [profile] device busy {busy['busy_ms']:.2f} of "
              f"{busy['window_ms']:.2f} ms, NCCL {busy['nccl_pct']:.1f}%, "
              f"idle {busy['idle_pct']:.1f}%")


def _load_artifact(args):
    """The ExportedStabilizer ``--artifact`` names, or None after printing
    why the flags refuse it: the artifact holds the weights, the chunk
    size, strength, crop and smoothing it was exported with."""
    if args.checkpoint or args.preset:
        _err("--artifact already contains the weights; drop "
             "--checkpoint/--preset")
        return None
    if str(args.border_crop).strip().lower() == "auto":
        _err("--border-crop auto needs the two-pass pipeline; an --artifact "
             "bakes its crop at export time")
        return None
    crop = _parse_border_crop(args.border_crop)
    if crop is None:
        return None
    if crop != 0.0:
        _err("the artifact's border-crop was baked at export time; export "
             "again with python -m dvsg_tpu_torch export --border-crop")
        return None
    baked = [name for name, given in
             (("--strength", args.strength is not None),
              ("--chunk-frames", args.chunk_frames is not None),
              ("--warp-impl", args.warp_impl is not None),
              ("--path-smooth", args.path_smooth != 0),
              ("--dtype", args.dtype is not None),
              ("--path-smooth-lag", args.path_smooth_lag != 0)) if given]
    if baked:
        _err(f"{', '.join(baked)}: baked into the artifact at export time; "
             "export again, or stabilize from a checkpoint")
        return None
    from dvsg_tpu_torch import export as export_lib
    try:
        loaded = export_lib.load_exported(args.artifact,
                                          device=args.platform)
    except ValueError as e:
        _err(str(e))
        return None
    cfg = loaded.cfg
    print(f"artifact {args.artifact}: T={cfg.chunk_frames}, "
          f"strength={cfg.strength}, border_crop={cfg.border_crop}, "
          f"path_smooth={cfg.path_smooth} (baked at export)",
          file=sys.stderr)
    return loaded


def stabilize_batch_main(argv=None) -> int:
    """Stabilize a batch of clips together: one batched device step per
    chunk for all of them (pipeline/multiclip.py). Under ``torchrun
    --nproc-per-node N`` each rank drives ``cuda:$LOCAL_RANK`` and, when the
    clip count divides over the N ranks, stabilizes and writes its own
    N-th of the clips (per-clip data parallelism); otherwise rank 0 runs
    the whole batch."""
    p = argparse.ArgumentParser(
        prog="python -m dvsg_tpu_torch stabilize-batch",
        description="Stabilize a batch of same-resolution clips together.")
    p.add_argument("--inputs", nargs="+", required=True)
    p.add_argument("--outputs", nargs="+", required=True)
    p.add_argument("--no-mesh", action="store_true",
                   help="under torchrun with several ranks, run the whole "
                        "batch on rank 0 instead of sharding the clips over "
                        "the ranks")
    p.add_argument("--border-crop", default="0",
                   help="crop fraction, or 'auto': a predict-only scan over "
                        "all clips picks one shared smallest crop")
    _add_common_args(p)
    args = p.parse_args(argv)
    if len(args.inputs) != len(args.outputs):
        return _err("--inputs and --outputs must pair up")
    checked = _check_common(args)
    if checked is None:
        return 2
    params, mcfg, border_crop, chunk = checked

    import torch

    from dvsg_tpu_torch.config import StabilizeConfig
    from dvsg_tpu_torch.parallel import mesh as mesh_lib
    from dvsg_tpu_torch.pipeline import pathsmooth

    try:
        cfg = StabilizeConfig(model=mcfg, chunk_frames=chunk,
                              strength=args.strength, **_smooth_kwargs(args))
        pathsmooth.lag_reject(cfg, "stabilize-batch (stabilize each clip "
                              "for a lag run)")
    except ValueError as e:
        return _err(str(e))
    # A process group when torchrun started this process (left again at
    # the end); else one rank.
    already = torch.distributed.is_initialized()
    owns_group = (mesh_lib.init_distributed(device=args.platform) is not None
                  and not already)
    try:
        return _run_batch(args, cfg, params, border_crop)
    finally:
        if owns_group:
            torch.distributed.destroy_process_group()


def _run_batch(args, cfg, params, border_crop) -> int:
    """stabilize-batch after its flags are checked: the mesh, the readers
    and this rank's writers, the batch, the summary."""
    from dvsg_tpu_torch.parallel import mesh as mesh_lib
    from dvsg_tpu_torch.pipeline.multiclip import stabilize_multi
    from dvsg_tpu_torch.utils import video_io
    from dvsg_tpu_torch.utils.metrics import StageTimer, write_metrics_jsonl

    n_dev = mesh_lib.world_size()
    rank = mesh_lib.world_rank()
    mesh = None
    if not args.no_mesh and n_dev > 1 and len(args.inputs) % n_dev == 0:
        mesh = mesh_lib.make_mesh(device=args.platform)
        if rank == 0:
            print(f"per-clip DP over {n_dev} devices")
    elif rank != 0:
        print(f"rank {rank}: the batch runs on rank 0 (no mesh)",
              file=sys.stderr)
        return 0
    device = mesh_lib.rank_device(args.platform)
    mine = (mesh.shard(len(args.inputs), "clip count") if mesh is not None
            else slice(None))
    if mesh is not None:
        print(f"rank {rank} of {n_dev} on {mesh.device}: writes "
              f"{', '.join(args.outputs[mine])}", file=sys.stderr)
    readers = [video_io.VideoReader(p_) for p_ in args.inputs]
    writers = []
    try:
        h, w = readers[0].height, readers[0].width
        for i, r in enumerate(readers):
            if (r.height, r.width) != (h, w):
                # Before any writer exists: opening the writers creates or
                # truncates every output.
                return _err(
                    f"all clips must share one resolution for a batch: "
                    f"{args.inputs[i]} is {r.width}x{r.height}, "
                    f"{args.inputs[0]} is {w}x{h}; run them as separate "
                    "jobs (or through the server, which groups by "
                    "resolution)")
        _auto_chunk_notice(args, h, w, len(args.inputs) // (
            n_dev if mesh is not None else 1))
        if border_crop == "auto":
            border_crop = _run_autocrop_scan(cfg, params, args.inputs,
                                             device)
        cfg = cfg.replace(border_crop=border_crop)
        # Each rank opens the writers of its own clips only.
        writers = [None] * len(args.outputs)
        for i in range(len(args.outputs))[mine]:
            writers[i] = video_io.VideoWriter(args.outputs[i], w, h,
                                              readers[i].fps)
        timer = StageTimer()
        t0 = time.perf_counter()
        result = stabilize_multi(cfg, params, readers, writers, mesh=mesh,
                                 timer=timer, device=device)
        wall = time.perf_counter() - t0
    finally:
        # Close even when stabilize_multi raises: it has joined its encode
        # workers, so this finalizes the partial outputs (the resume
        # points).
        for r in readers:
            r.close()
        for w_ in writers:
            if w_ is not None:
                w_.close()
    if rank != 0:
        return 0 if result.ok else 3
    written = result.frames_written
    total = sum(written)
    fps = total / wall if wall else 0.0
    print(f"stabilized {len(written)} clips / {total} frames at {w}x{h} on "
          f"{args.platform} in {wall:.2f}s ({fps:.1f} frames/s aggregate)")
    _print_stages(timer)
    for i in result.failed_clips:
        print(f"FAILED clip {args.inputs[i]} after {written[i]} frames: "
              f"{result.errors[i]} — re-run it (frame-dir outputs resume at "
              "the written count)", file=sys.stderr)
    if args.metrics_out:
        write_metrics_jsonl(args.metrics_out, {
            "kind": "stabilize_batch", "clips": len(written),
            "frames": total, "wall_s": wall, "fps": fps,
            "width": w, "height": h, "device": args.platform,
            "devices": n_dev, "mesh": mesh is not None,
            "stages": timer.summary(), "failed_clips": result.failed_clips,
            "coverage_fallback_chunks": result.coverage_fallback_chunks})
    return 0 if result.ok else 3


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
    p.add_argument("--chunk-frames", type=int, default=None,
                   help="frames per device step (default or 0: the auto "
                        "pick, 16)")
    _add_warp_impl_arg(p)
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
    p.add_argument("--path-smooth", type=int, default=0, metavar="FRAMES",
                   help="evaluate with camera-path smoothing (see stabilize "
                        "--path-smooth); psnr_vs_target scores against the "
                        "window-mean target, which a smoothed output "
                        "deviates from on purpose")
    p.add_argument("--path-smooth-lag", type=int, default=0, metavar="D",
                   help="evaluate the fixed-lag smoothing mode (see "
                        "stabilize --path-smooth-lag)")
    _add_model_args(p)
    args = p.parse_args(argv)
    chunk = _chunk_frames(args)
    if _bad_warp_impl(args.warp_impl) or chunk is None:
        return 2
    params, mcfg = _load_model(args)

    import torch

    from dvsg_tpu_torch.config import StabilizeConfig
    from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
    from dvsg_tpu_torch.train.eval import evaluate_synthetic
    from dvsg_tpu_torch.utils.metrics import write_metrics_jsonl

    h, w = args.size
    _auto_chunk_notice(args, h, w)
    try:
        cfg = StabilizeConfig(model=mcfg, chunk_frames=chunk,
                              path_smooth=args.path_smooth,
                              path_smooth_lag=args.path_smooth_lag)
    except ValueError as e:
        return _err(str(e))
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


def export_main(argv=None) -> int:
    """Export the chunk step with its weights into the port's artifact
    (export.py), for ``stabilize --artifact`` or ``export.load_exported``.
    ``--for-platform cuda`` writes the card's artifact from any host, one
    without a card included; unlike the reference's ``--for-platform`` it
    picks no warp route, since the port has one."""
    p = argparse.ArgumentParser(
        prog="python -m dvsg_tpu_torch export",
        description="Export the per-chunk stabilization program (weights "
                    "inside) for deployment.")
    p.add_argument("--checkpoint", default=None,
                   help="training checkpoint directory or .npz; the "
                        "committed fast model if omitted (an untrained "
                        "identity model if model flags are given)")
    p.add_argument("--preset", choices=tuple(_PRESETS),
                   help="committed pretrained model: 'fast' or 'quality'")
    p.add_argument("--output", required=True, help="artifact file")
    p.add_argument("--size", type=int, nargs=2, required=True,
                   metavar=("H", "W"),
                   help="frame resolution the program is traced for")
    p.add_argument("--chunk-frames", type=int, default=None,
                   help="frames per device step (default or 0: the auto "
                        "pick, 16)")
    _add_warp_impl_arg(p)
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda",
                   help="device the program is traced for and runs on "
                        "(default cuda)")
    p.add_argument("--for-platform", choices=("cuda", "cpu"), default=None,
                   metavar="PLAT",
                   help="export for this device type from any host instead "
                        "of tracing on --platform: 'cuda' traces for the "
                        "card under fake tensors, so a build host without "
                        "one can ship the card's artifact")
    p.add_argument("--border-crop", type=float, default=0.0)
    p.add_argument("--strength", type=float, default=1.0)
    _add_smooth_args(p)
    _add_model_args(p)
    args = p.parse_args(argv)
    chunk = _chunk_frames(args)
    if _bad_warp_impl(args.warp_impl) or chunk is None:
        return 2
    params, mcfg = _load_model(args)
    from dvsg_tpu_torch import export as export_lib
    from dvsg_tpu_torch.config import StabilizeConfig
    h, w = args.size
    _auto_chunk_notice(args, h, w)
    try:
        cfg = StabilizeConfig(model=mcfg, chunk_frames=chunk,
                              border_crop=args.border_crop,
                              strength=args.strength, **_smooth_kwargs(args))
        exp = export_lib.export_chunk_program(
            cfg, params, h, w, device=args.platform,
            for_device=args.for_platform)
    except ValueError as e:
        return _err(str(e))
    export_lib.save_exported(exp, args.output, cfg,
                             extra={"checkpoint": args.checkpoint})
    print(f"exported {w}x{h} T={cfg.chunk_frames} program for "
          f"{exp.device} -> {args.output} "
          f"({os.path.getsize(args.output) / 1e6:.1f} MB, traced in "
          f"{exp.export_s:.1f}s)")
    return 0


def _friendly_errors(fn):
    """The reference CLI's handling of expected user errors: a missing
    file prints ``ERROR: not found: <path>``, an I/O or value error
    ``ERROR: <message>``, each on stderr with exit code 2, no traceback."""
    @functools.wraps(fn)
    def wrapped(argv=None):
        try:
            return fn(argv)
        except FileNotFoundError as e:
            return _err(f"not found: {e}")
        except (IOError, ValueError) as e:
            return _err(str(e))
    return wrapped


stabilize_main = _friendly_errors(stabilize_main)
stabilize_batch_main = _friendly_errors(stabilize_batch_main)
train_main = _friendly_errors(train_main)
eval_main = _friendly_errors(eval_main)
export_main = _friendly_errors(export_main)

_COMMANDS = {"stabilize": stabilize_main,
             "stabilize-batch": stabilize_batch_main, "train": train_main,
             "eval": eval_main, "export": export_main}


def main(argv=None) -> int:
    """The reference's exits: usage on stdout with 0 for ``-h``/``--help``
    and 1 for no arguments, 2 for an unknown command."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m dvsg_tpu_torch "
              "{stabilize|stabilize-batch|train|eval|export} [args]\n"
              "       see --help of each subcommand")
        return 0 if argv else 1
    if argv[0] not in _COMMANDS:
        print(f"unknown command {argv[0]!r}; expected "
              "stabilize|stabilize-batch|train|eval|export", file=sys.stderr)
        return 2
    return _COMMANDS[argv[0]](argv[1:])
