#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``dvsg_tpu_torch``).

    python3 chip_smoke.py [--seed 0]

Needs one CUDA card (cuda:0), nvcc and the repository's sources; exits
non-zero without a card or outside the repository. Phases, each raising
on failure:

1. card, power limit and versions; build every kernel with nvcc;
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes and at edge shapes (max |diff| <= 1 LSB);
3. the main path, ``Stabilizer.stabilize_clip`` with T = 16 on a seeded
   48-frame 1280x720 shaky clip, for both shipped presets at full width and
   depth: output shape and dtype, one kernel launch per chunk,
   ``stabilize_stream`` with a resume record byte-identical to the clip
   path, the card within 1 LSB of the CPU path on a small clip, and a
   positive PSNR gain;
4. times with CUDA events after warm-up: each chunk stage, the device
   chunk, end-to-end frames/s, where a stream's host time goes (decode,
   h2d, compute, d2h, encode), and the kernel beside its memory bound,
   its plain version and ``F.grid_sample`` (timed here as a yardstick only;
   the port never calls it).

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. ``--json PATH`` also writes every
measured number there.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from dvsg_tpu_torch.config import StabilizeConfig
from dvsg_tpu_torch.models import motion_cnn
from dvsg_tpu_torch.ops import _build
from dvsg_tpu_torch.ops import grid as grid_ops
from dvsg_tpu_torch.ops import resize as resize_ops
from dvsg_tpu_torch.ops import warp_ref, warp_wide
from dvsg_tpu_torch.pipeline import stabilize as stab_lib
from dvsg_tpu_torch.utils.checkpoint import load_npz
from dvsg_tpu_torch.utils.metrics import StageTimer, psnr

ROOT = os.path.dirname(os.path.abspath(__file__))
PRESETS = (("fast", "flagship_fast.npz"), ("quality", "flagship.npz"))
KERNELS = ("warp_u8_offsets",)     # csrc/<name>.cu
T_CHUNK = 16
N_FRAMES = 48
HEIGHT, WIDTH = 720, 1280
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device ms per call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --- seeded fixtures -------------------------------------------------------

def make_still(rng, h: int, w: int, dev) -> torch.Tensor:
    """Smooth random texture in [0, 1], (h, w, 3): four octaves of uniform
    noise, bilinearly upsampled, low frequencies dominant."""
    img = torch.zeros(h, w, 3, device=dev)
    for res, amp in ((4, 0.5), (8, 0.25), (16, 0.15), (64, 0.10)):
        coarse = torch.from_numpy(
            rng.random((res, res, 3), dtype=np.float32)).to(dev)
        img += amp * resize_ops.downscale_bilinear(coarse, h, w)
    img -= img.min()
    return img / img.max()


def make_path(rng, n: int, max_trans=0.08, max_angle=0.05) -> np.ndarray:
    """Camera shake (n, 3) of (tx, ty, angle): a random walk pulled back
    toward the still (x_t = 0.5 x_{t-1} + noise), so the still is the
    stable reference a stabilizer should recover."""
    steps = rng.standard_normal((n, 3))
    path = np.zeros((n, 3))
    x = np.zeros(3)
    for t in range(n):
        x = 0.5 * x + steps[t]
        path[t] = x
    path -= path.mean(axis=0, keepdims=True)
    path /= np.maximum(np.abs(path).max(axis=0, keepdims=True), 1e-6)
    return path * np.array([max_trans, max_trans, max_angle]) \
        * rng.uniform(0.3, 1.0, 3)


def render(still: torch.Tensor, path: np.ndarray) -> np.ndarray:
    """Shaky uint8 frames: the still sampled through each pose, with the
    port's plain warp."""
    h, w, _ = still.shape
    ident = grid_ops.identity_grid(h, w, still.device)
    x, y = ident[..., 0], ident[..., 1]
    outs = []
    for i in range(0, len(path), 16):
        p = torch.tensor(path[i:i + 16], dtype=torch.float32,
                         device=still.device)[:, :, None, None]
        tx, ty, a = p[:, 0], p[:, 1], p[:, 2]
        g = torch.stack([torch.cos(a) * x - torch.sin(a) * y + tx,
                         torch.sin(a) * x + torch.cos(a) * y + ty], dim=-1)
        fr = warp_ref.bilinear_warp_batch(
            still[None].expand(len(g), h, w, 3), g)
        outs.append(stab_lib.quantize_frames(fr).cpu().numpy())
    return np.concatenate(outs)


def make_clip(seed: int, n: int, h: int, w: int, dev):
    rng = np.random.default_rng(seed)
    still = make_still(rng, h, w, dev)
    path = make_path(rng, n)
    return (render(still, path),
            stab_lib.quantize_frames(still).cpu().numpy(), path)


def interior(a: np.ndarray, border: float = 0.125) -> np.ndarray:
    h, w = a.shape[-3], a.shape[-2]
    bh, bw = int(h * border), int(w * border)
    return a[..., bh:h - bh, bw:w - bw, :]


class MemReader:
    """In-memory reader with the VideoReader methods the stream uses."""

    def __init__(self, frames: np.ndarray):
        self.frames, self.pos = frames, 0

    def read_batch(self, n: int) -> np.ndarray:
        out = self.frames[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def skip(self, n: int) -> int:
        k = min(n, len(self.frames) - self.pos)
        self.pos += k
        return k


class MemWriter:
    """In-memory appendable writer (VideoWriter's write_batch/seek)."""

    def __init__(self, total: int, shape):
        self.frames = np.zeros((total, *shape), np.uint8)
        self.pos = 0

    def seek(self, i: int) -> None:
        self.pos = i

    def write_batch(self, frames: np.ndarray) -> None:
        self.frames[self.pos:self.pos + len(frames)] = frames
        self.pos += len(frames)


# --- phases ----------------------------------------------------------------

def phase_kernel_checks(rng, dev) -> float:
    """B1 against its plain version; returns the max |diff| in LSB."""
    cases = [((T_CHUNK, HEIGHT, WIDTH, 3), 0.2, 0.0),
             ((T_CHUNK, HEIGHT, WIDTH, 3), 0.2, 0.05),
             ((T_CHUNK, 480, 854, 3), 0.2, 0.0),
             ((4, HEIGHT, WIDTH, 3), 1.5, 0.0)]      # border clamp
    worst = 0
    for shape, amp, crop in cases:
        frames = torch.from_numpy(
            rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        offs = torch.from_numpy(rng.uniform(
            -amp, amp, (shape[0], 16, 16, 2)).astype(np.float32)).to(dev)
        out_k = warp_wide.warp_u8_offsets(frames, offs, crop)
        out_p = warp_wide.warp_u8_offsets_plain(frames, offs, crop)
        torch.cuda.synchronize()
        diff = (out_k.to(torch.int16) - out_p.to(torch.int16)).abs()
        maxd = int(diff.max())
        share = float((diff > 0).float().mean())
        log(f"  warp_u8_offsets {shape} offsets ±{amp} crop {crop}: "
            f"max |diff| {maxd} LSB, {share:.3e} of values differ")
        if maxd > 1:
            raise AssertionError(f"kernel differs from plain by {maxd} LSB "
                                 f"at {shape}, crop {crop}")
        worst = max(worst, maxd)
    return worst


def phase_main_path(seed: int, dev):
    """Both presets through the user entry points; returns (launches in
    the main-path runs, per-preset results, stabilizers, clip)."""
    clip, still, _ = make_clip(seed, N_FRAMES, HEIGHT, WIDTH, dev)
    small, _, _ = make_clip(seed + 1, 20, 180, 320, dev)
    n_chunks = math.ceil(N_FRAMES / T_CHUNK)
    launches = 0
    results, stabs = {}, {}
    for preset, ckpt in PRESETS:
        params, mcfg = load_npz(os.path.join(ROOT, "checkpoints", ckpt))
        cfg = StabilizeConfig(model=mcfg, chunk_frames=T_CHUNK)
        stab = stab_lib.Stabilizer(cfg, params, device="cuda")

        warp_wide.LAUNCHES = 0
        out = stab.stabilize_clip(clip)
        torch.cuda.synchronize()
        n = warp_wide.LAUNCHES
        launches += n
        log(f"  [{preset}] stabilize_clip {clip.shape}: {n} kernel "
            f"launches for {n_chunks} chunks")
        if out.shape != clip.shape or out.dtype != np.uint8:
            raise AssertionError(f"output {out.shape} {out.dtype}")
        if n != n_chunks:
            raise AssertionError(f"{n} launches for {n_chunks} chunks")

        with tempfile.TemporaryDirectory() as resume_dir:
            reader = MemReader(clip)
            writer = MemWriter(len(clip), clip.shape[1:])
            written = stab.stabilize_stream(reader, writer,
                                            resume_dir=resume_dir)
            rec_ok = os.path.exists(os.path.join(resume_dir,
                                                 "resume_state.npz"))
        if written != len(clip) or not rec_ok:
            raise AssertionError(f"stream wrote {written}, record {rec_ok}")
        if not np.array_equal(writer.frames, out):
            raise AssertionError("stabilize_stream differs from "
                                 "stabilize_clip")

        cpu = stab_lib.Stabilizer(cfg, params, device="cpu")
        ref = cpu.stabilize_clip(small)
        got = stab.stabilize_clip(small)
        cpu_lsb = int(np.abs(ref.astype(int) - got).max())
        if cpu_lsb > 1:
            raise AssertionError(f"card vs CPU path: {cpu_lsb} LSB")

        s = np.broadcast_to(still, clip.shape)
        p_in = psnr(interior(clip), interior(s))
        p_out = psnr(interior(out), interior(s))
        log(f"  [{preset}] stream == clip (resume record written); card "
            f"vs CPU path on {small.shape}: max {cpu_lsb} LSB; PSNR vs "
            f"still centre: shaky {p_in:.3f} dB -> stabilized "
            f"{p_out:.3f} dB, gain {p_out - p_in:+.3f} dB")
        if not p_out - p_in > 0:
            raise AssertionError(f"no PSNR gain ({p_out - p_in:+.3f} dB)")
        results[preset] = {"launches": n, "chunks": n_chunks,
                           "psnr_in_db": p_in, "psnr_out_db": p_out,
                           "psnr_gain_db": p_out - p_in,
                           "card_vs_cpu_max_lsb": cpu_lsb}
        stabs[preset] = stab
    return launches, results, stabs, clip


@torch.inference_mode()
def phase_times(stabs, clip, dev, results):
    """Per-stage and end-to-end times; returns B1's timing record."""
    frames = stab_lib.put_frames(clip[:T_CHUNK], dev)
    b1 = None
    for preset, stab in stabs.items():
        cfg, model = stab.cfg, stab.model
        mh, mw = cfg.model.model_size
        n = cfg.model.window
        halo = stab._initial_halo(clip[0])
        small = resize_ops.downscale_norm(frames, mh, mw)
        seq = torch.cat([halo, small])
        feats = motion_cnn.encode_frames(model, seq)
        idx = (torch.arange(T_CHUNK, device=dev)[:, None]
               + torch.arange(n, device=dev)[None, :])
        offsets = motion_cnn.offsets_from_feature_windows(model, feats[idx])
        stages = {
            "downscale_norm": time_ms(
                lambda: resize_ops.downscale_norm(frames, mh, mw)),
            "encoder": time_ms(lambda: motion_cnn.encode_frames(model, seq)),
            "head": time_ms(lambda: motion_cnn.offsets_from_feature_windows(
                model, feats[idx])),
            "warp_u8_offsets": time_ms(lambda: warp_wide.warp_u8_offsets(
                frames, offsets, cfg.border_crop)),
            "chunk": time_ms(lambda: stab_lib.stabilize_chunk_impl(
                cfg, model, frames, halo)),
        }
        walls = []
        for _ in range(4):
            t0 = time.perf_counter()
            stab.stabilize_clip(clip)
            walls.append(time.perf_counter() - t0)
        e2e_fps = len(clip) / float(np.median(walls[1:]))
        dev_fps = 1e3 * T_CHUNK / stages["chunk"]
        # Where a stream's host time goes (compute ends in a synchronize).
        timer = StageTimer()
        t0 = time.perf_counter()
        stab.stabilize_stream(MemReader(clip),
                              MemWriter(len(clip), clip.shape[1:]),
                              timer=timer)
        stream_s = time.perf_counter() - t0
        stream = {k: v["total_s"] for k, v in timer.summary().items()}
        log(f"  [{preset}] per chunk (T={T_CHUNK}, {WIDTH}x{HEIGHT}): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in stages.items()))
        log(f"  [{preset}] device chunk loop {dev_fps:.1f} frames/s; "
            f"stabilize_clip end to end (host arrays in and out) "
            f"{e2e_fps:.1f} frames/s")
        log(f"  [{preset}] stabilize_stream {len(clip)} frames in "
            f"{1e3 * stream_s:.2f} ms: "
            + ", ".join(f"{k} {1e3 * v:.2f} ms" for k, v in stream.items()))
        results[preset].update({"stage_ms": stages, "device_fps": dev_fps,
                                "e2e_fps": e2e_fps, "e2e_wall_s": walls,
                                "stream_s": stream_s,
                                "stream_stage_s": stream})
        if b1 is None:
            b1 = time_b1(frames, offsets, cfg.border_crop)
    return b1


def time_b1(frames, offsets, crop) -> dict:
    b, h, w, c = frames.shape
    gh, gw = offsets.shape[1:3]
    # ms is the wrapper's time: the offsets' row upsample (one einsum) and
    # the kernel. kernel_ms is the kernel's launch alone, on those rows.
    ms = time_ms(lambda: warp_wide.warp_u8_offsets(frames, offsets, crop),
                 iters=50)
    rows = warp_wide.offset_rows(offsets, h)
    kernel_ms = time_ms(lambda: warp_wide._launch(frames, rows, crop),
                        iters=50)
    plain_ms = time_ms(lambda: warp_wide.warp_u8_offsets_plain(
        frames, offsets, crop), iters=10)
    # Yardstick: one grid_sample call computing the same warp on f32 NCHW
    # frames from the dense grid (both made outside the timed call).
    src = frames.permute(0, 3, 1, 2).to(torch.float32).contiguous()
    grids = grid_ops.grid_from_offsets(offsets, h, w, crop)
    lib_ms = time_ms(lambda: F.grid_sample(
        src, grids, mode="bilinear", padding_mode="border",
        align_corners=True), iters=20)
    # Bound: frames read once and written once, offsets read once; ~60 f32
    # operations per output pixel (coordinates, 4 taps x C lerps, rounds).
    n_bytes = 2 * b * h * w * c + offsets.numel() * 4
    n_ops = b * h * w * (30 + 10 * c)
    bytes_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * n_ops / PEAK_F32_FLOPS
    bound_ms = max(bytes_ms, ops_ms)
    rec = {"ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": lib_ms,
           "bound_ms": bound_ms,
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "frames_per_call": b, "shape": [b, h, w, c], "grid": [gh, gw]}
    log(f"  warp_u8_offsets {b}x{h}x{w}x{c}: {ms:.4f} ms/call = "
        f"{1e3 * ms / b:.3f} us/frame (kernel alone {kernel_ms:.4f} "
        f"ms); bound {1e3 * bound_ms / b:.3f} "
        f"us/frame ({rec['bound_by']}); plain {1e3 * plain_ms / b:.3f} "
        f"us/frame; F.grid_sample {1e3 * lib_ms / b:.3f} us/frame")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write every measured number to PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs on a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    log("== phase 1: card and build")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    for name in KERNELS:
        _build.library(name)
    build_s = time.perf_counter() - t0
    log(f"built and loaded {list(KERNELS)} in {build_s:.2f} s")

    log("== phase 2: kernels against their plain versions")
    rng = np.random.default_rng(args.seed)
    max_lsb = phase_kernel_checks(rng, dev)

    log("== phase 3: main path, both presets, 1280x720")
    launches, results, stabs, clip = phase_main_path(args.seed, dev)

    log("== phase 4: times")
    b1 = phase_times(stabs, clip, dev, results)
    kernels = [{
        "name": "warp_u8_offsets",
        "route": "cuda",
        "source": "dvsg_tpu_torch/csrc/warp_u8_offsets.cu",
        "replaces": "dvsg_tpu/ops/warp_wide.py:767",
        "launches": launches,
        "max_abs_err": max_lsb,
        "ms": b1["ms"],
        "plain_ms": b1["plain_ms"],
        "bound_ms": b1["bound_ms"],
        "bound_by": b1["bound_by"],
        "library_ms": b1["library_ms"],
    }]
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "seed": args.seed,
              "kernels": kernels, "b1": b1, "presets": results,
              "build_s": build_s,
              "wall_s": time.perf_counter() - t_start}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
    log(f"total {record['wall_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
