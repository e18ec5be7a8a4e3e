#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``dvsg_tpu_torch``).

    python3 chip_smoke.py [--seed 0]

Needs one CUDA card (cuda:0), nvcc and the repository's sources; exits
non-zero without a card or outside the repository. Phases, each raising
on failure:

1. card, power limit and versions; build every kernel with nvcc, one
   process per source, started together;
2. each kernel against its plain PyTorch version on the card, at its main
   path's shapes and at edge shapes: the uint8 kernels within 1 LSB, the
   f32 warp within 1e-5, its derivative images within 1e-4, its grid
   gradient within 1e-4 of the largest gradient;
3. the stabilize path, ``Stabilizer.stabilize_clip`` with T = 16 on a
   seeded 48-frame 1280x720 shaky clip, for both shipped presets at full
   width and depth: output shape and dtype, one kernel launch per chunk,
   ``stabilize_stream`` with a resume record byte-identical to the clip
   path, the card within 1 LSB of the CPU path on a small clip, a positive
   PSNR gain, and the same chunk through ``warp_quantize_batch(grids=...)``
   (the dense-grid kernel) within 1 LSB of the offsets kernel;
4. times of that path with CUDA events after warm-up: each chunk stage,
   the device chunk, end-to-end frames/s, where a stream's host time goes;
5. the training path, ``train.loop.train`` from a seeded init at the full
   width of both shipped model configs (batch 8, window 5) and a fine-tune
   of the committed ``fast`` weights: finite losses, the offset loss
   falling (and falling by half on one fixed batch), one launch of each
   training kernel per step, one step's loss
   and parameter gradients through the kernels equal to the same step
   through the plain versions, a checkpoint saved, reloaded and resumed at
   the uninterrupted run's loss; then ``evaluate_synthetic`` of the
   committed and the fine-tuned weights;
6. times of a train step (data generation, forward, loss warp, backward,
   optimizer; medians of 20) and of each kernel beside its bound, its
   plain version and ``F.grid_sample`` (timed here as a yardstick only;
   the port never calls it).

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. ``--json PATH`` also writes every
measured number there.
"""

from __future__ import annotations

import argparse
import contextlib
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

from dvsg_tpu_torch.config import StabilizeConfig, TrainConfig
from dvsg_tpu_torch.models import motion_cnn
from dvsg_tpu_torch.ops import _build
from dvsg_tpu_torch.ops import grid as grid_ops
from dvsg_tpu_torch.ops import resize as resize_ops
from dvsg_tpu_torch.ops import warp as warp_ops
from dvsg_tpu_torch.ops import warp_bilinear, warp_ref, warp_wide
from dvsg_tpu_torch.pipeline import stabilize as stab_lib
from dvsg_tpu_torch.train import eval as eval_lib
from dvsg_tpu_torch.train import loop as train_loop
from dvsg_tpu_torch.utils import checkpoint as ckpt_lib
from dvsg_tpu_torch.utils.checkpoint import load_npz
from dvsg_tpu_torch.utils.metrics import StageTimer, psnr

ROOT = os.path.dirname(os.path.abspath(__file__))
PRESETS = (("fast", "flagship_fast.npz"), ("quality", "flagship.npz"))
SOURCES = ("warp_u8_offsets", "warp_bilinear", "warp_u8_batch")  # csrc/
# Training runs: (preset, steps from a seeded init); batch 8, window 5.
TRAIN_RUNS = (("fast", 60), ("quality", 30))
TRAIN_BATCH = 8
TRAIN_LR = 1e-3
FINETUNE_STEPS = 6
OVERFIT_STEPS = 60
EVAL_FRAMES, EVAL_SIZE = 32, (480, 640)
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


_scratch = {}


def _stall_and_flush(dev):
    """(stall, flush): a ~10 ms matrix product that keeps the card busy
    while the host queues the timed calls behind it, and a write over a
    buffer larger than the 50 MB L2 that empties the cache."""
    if not _scratch:
        _scratch["a"] = torch.randn(6144, 6144, device=dev)
        _scratch["l2"] = torch.empty(96 * 1024 * 1024, dtype=torch.uint8,
                                     device=dev)
    return (lambda: torch.mm(_scratch["a"], _scratch["a"]),
            _scratch["l2"].zero_)


def median_ms(fn, iters: int = 20, warmup: int = 3, cold: bool = True
              ) -> float:
    """Median device ms of ``iters`` single calls, each between its own
    pair of CUDA events. The calls are queued behind a long kernel, so a
    short kernel's time is not the host's time to launch it; with ``cold``
    the L2 cache is emptied before each call, as the bounds assume device
    memory traffic."""
    stall, flush = _stall_and_flush(torch.device("cuda", 0))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    stall()
    pairs = []
    for _ in range(iters):
        if cold:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def bound(n_bytes: float, n_ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the f32 rate."""
    bytes_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * n_ops / PEAK_F32_FLOPS
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


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

def smooth_grids(rng, b: int, ho: int, wo: int, spill: float, dev
                 ) -> torch.Tensor:
    """Seeded dense grids (b, ho, wo, 2): a random homography of the
    identity plus fine noise, scaled by ``spill`` (> 1 leaves the frame on
    both sides)."""
    theta = torch.eye(3).repeat(b, 1, 1)
    theta[:, :2] += torch.from_numpy(
        rng.uniform(-0.08, 0.08, (b, 2, 3)).astype(np.float32))
    theta[:, 2, :2] += torch.from_numpy(
        rng.uniform(-0.02, 0.02, (b, 2)).astype(np.float32))
    g = grid_ops.homography_grid(theta.to(dev), ho, wo)
    noise = torch.from_numpy(rng.uniform(
        -0.01, 0.01, (b, ho, wo, 2)).astype(np.float32)).to(dev)
    return ((g + noise) * spill).contiguous()


# Dense-grid kernel checks: (frames shape, output size, spill). The first
# four are the training path's shapes (64 rendered frames and 16 loss
# frames per step, 256^2 for quality and 128^2 for fast); the rest are edge
# shapes.
F32_CASES = (((64, 256, 256, 3), (256, 256), 1.0),
             ((16, 256, 256, 3), (256, 256), 1.0),
             ((64, 128, 128, 3), (128, 128), 1.0),
             ((16, 128, 128, 3), (128, 128), 1.0),
             ((3, 97, 131, 3), (75, 53), 1.4),
             ((2, 33, 257, 1), (61, 300), 2.0))
U8_EDGE_CASES = (((3, 97, 131, 3), (75, 53), 1.4),
                 ((2, 33, 257, 4), (61, 300), 2.0))


def phase_dense_kernel_checks(rng, dev) -> dict:
    """The dense-grid kernels against their plain versions; returns each
    kernel's worst error (f32: max |diff|; uint8: LSB)."""
    worst = {"warp_f32": 0.0, "warp_f32_diff_fwd": 0.0,
             "warp_f32_diff_bwd": 0.0, "warp_u8_batch": 0}
    for shape, (ho, wo), spill in F32_CASES:
        b, h, w, c = shape
        frames = torch.from_numpy(rng.random(shape, dtype=np.float32)
                                  ).to(dev)
        grids = smooth_grids(rng, b, ho, wo, spill, dev)
        cot = torch.from_numpy(rng.standard_normal(
            (b, ho, wo, c)).astype(np.float32)).to(dev)
        out_k = warp_bilinear.bilinear_warp_batch(frames, grids)
        out_p = warp_bilinear.bilinear_warp_batch_plain(frames, grids)
        o_k, dx_k, dy_k = warp_bilinear.warp_diff_forward(frames, grids)
        o_p, dx_p, dy_p = warp_bilinear.warp_diff_forward_plain(frames,
                                                                grids)
        dg_k = warp_bilinear.warp_diff_backward(cot, dx_p, dy_p, grids,
                                                h, w)
        dg_p = warp_bilinear.warp_diff_backward_plain(cot, dx_p, dy_p,
                                                      grids, h, w)
        torch.cuda.synchronize()
        e_warp = float((out_k - out_p).abs().max())
        e_val = float((o_k - o_p).abs().max())
        e_der = max(float((dx_k - dx_p).abs().max()),
                    float((dy_k - dy_p).abs().max()))
        e_bwd = float((dg_k - dg_p).abs().max())
        g_max = float(dg_p.abs().max())
        held = float(((dg_p == 0).all(dim=-1)).float().mean())
        log(f"  warp_f32 {shape} -> {ho}x{wo} spill {spill}: value "
            f"{e_warp:.2e}; diff fwd value {e_val:.2e}, derivative images "
            f"{e_der:.2e}; diff bwd {e_bwd:.2e} of max |dgrid| "
            f"{g_max:.1f} ({held:.3f} of pixels fully masked)")
        if e_warp > 1e-5 or e_val > 1e-5:
            raise AssertionError(f"f32 warp value off by {e_warp:.2e} / "
                                 f"{e_val:.2e} at {shape}")
        if e_der > 1e-4:
            raise AssertionError(f"derivative images off by {e_der:.2e} "
                                 f"at {shape}")
        if e_bwd > 1e-4 * max(g_max, 1.0):
            raise AssertionError(f"grid gradient off by {e_bwd:.2e} of "
                                 f"{g_max:.1f} at {shape}")
        worst["warp_f32"] = max(worst["warp_f32"], e_warp)
        worst["warp_f32_diff_fwd"] = max(worst["warp_f32_diff_fwd"],
                                         e_val, e_der)
        worst["warp_f32_diff_bwd"] = max(worst["warp_f32_diff_bwd"], e_bwd)
    u8_cases = (((T_CHUNK, HEIGHT, WIDTH, 3), (HEIGHT, WIDTH), 1.0),
                *U8_EDGE_CASES)
    for shape, (ho, wo), spill in u8_cases:
        frames = torch.from_numpy(
            rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        grids = smooth_grids(rng, shape[0], ho, wo, spill, dev)
        out_k = warp_wide.warp_u8_batch(frames, grids)
        out_p = warp_wide.warp_u8_batch_plain(frames, grids)
        torch.cuda.synchronize()
        diff = (out_k.to(torch.int16) - out_p.to(torch.int16)).abs()
        maxd = int(diff.max())
        share = float((diff > 0).float().mean())
        log(f"  warp_u8_batch {shape} -> {ho}x{wo} spill {spill}: max "
            f"|diff| {maxd} LSB, {share:.3e} of values differ")
        if maxd > 1:
            raise AssertionError(f"warp_u8_batch differs from plain by "
                                 f"{maxd} LSB at {shape}")
        worst["warp_u8_batch"] = max(worst["warp_u8_batch"], maxd)
    return worst


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
    """Both presets through the user entry points; returns (launches of
    the offsets kernel and of the dense-grid kernel in the main-path runs,
    per-preset results, stabilizers, clip)."""
    clip, still, _ = make_clip(seed, N_FRAMES, HEIGHT, WIDTH, dev)
    small, _, _ = make_clip(seed + 1, 20, 180, 320, dev)
    n_chunks = math.ceil(N_FRAMES / T_CHUNK)
    launches = launches_dense = 0
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

        # The first chunk again through the dispatcher's dense-grid branch
        # (the dense-grid kernel's path): the same warp, within 1 LSB.
        with torch.inference_mode():
            frames = stab_lib.put_frames(clip[:T_CHUNK], dev)
            b1_out, _, offsets = stab_lib.stabilize_chunk_impl(
                cfg, stab.model, frames, stab._initial_halo(clip[0]))
            grids = grid_ops.grid_from_offsets(offsets, HEIGHT, WIDTH,
                                               cfg.border_crop)
            warp_wide.LAUNCHES_BATCH = 0
            dense = warp_ops.warp_quantize_batch(frames, grids=grids)
            torch.cuda.synchronize()
            n_dense = warp_wide.LAUNCHES_BATCH
        launches_dense += n_dense
        dense_lsb = int((dense.to(torch.int16)
                         - b1_out.to(torch.int16)).abs().max())
        log(f"  [{preset}] warp_quantize_batch(grids=) on the first chunk: "
            f"{n_dense} launch, max {dense_lsb} LSB from the offsets "
            f"kernel")
        if n_dense != 1 or dense_lsb > 1:
            raise AssertionError(f"dense-grid path: {n_dense} launches, "
                                 f"{dense_lsb} LSB")

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
                           "card_vs_cpu_max_lsb": cpu_lsb,
                           "dense_vs_offsets_max_lsb": dense_lsb}
        stabs[preset] = stab
    return launches, launches_dense, results, stabs, clip


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


# --- the training path -------------------------------------------------------

def reset_train_launches() -> None:
    warp_bilinear.LAUNCHES_WARP = 0
    warp_bilinear.LAUNCHES_DIFF_FWD = 0
    warp_bilinear.LAUNCHES_DIFF_BWD = 0


def train_launches() -> dict:
    return {"warp_f32": warp_bilinear.LAUNCHES_WARP,
            "warp_f32_diff_fwd": warp_bilinear.LAUNCHES_DIFF_FWD,
            "warp_f32_diff_bwd": warp_bilinear.LAUNCHES_DIFF_BWD}


@contextlib.contextmanager
def plain_warps():
    """Route the training path's two warps to their plain versions (on
    whatever device), to hold the kernels' step against."""
    saved = warp_ops.warp_batch, warp_ops.warp_batch_diff
    warp_ops.warp_batch = warp_bilinear.bilinear_warp_batch_plain
    warp_ops.warp_batch_diff = \
        warp_bilinear.bilinear_warp_batch_grids_diff_plain
    try:
        yield
    finally:
        warp_ops.warp_batch, warp_ops.warp_batch_diff = saved


def loss_and_grads(state, cfg, step: int):
    """(loss terms, gradients) of the batch of ``step`` on ``state``'s
    weights; no update."""
    state.optimizer.zero_grad(set_to_none=True)
    total, aux = train_loop.loss_fn(
        state.model, train_loop.step_generator(cfg.seed, step), cfg)
    total.backward()
    torch.cuda.synchronize()
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    state.optimizer.zero_grad(set_to_none=True)
    return {k: float(v.detach()) for k, v in aux.items()}, grads


def kernels_vs_plain_step(state, cfg, step: int) -> dict:
    """One step's loss and parameter gradients through the kernels against
    the same step through the plain versions, both on the card."""
    reset = train_launches()
    aux_k, grads_k = loss_and_grads(state, cfg, step)
    used = {k: v - reset[k] for k, v in train_launches().items()}
    with plain_warps():
        before = train_launches()
        aux_p, grads_p = loss_and_grads(state, cfg, step)
        if train_launches() != before:
            raise AssertionError("the plain step launched a kernel")
    if min(used.values()) < 1:
        raise AssertionError(f"the kernel step launched {used}")
    loss_rel = abs(aux_k["total"] - aux_p["total"]) / abs(aux_p["total"])
    grad_rel = max(
        float((grads_k[n] - g).abs().max()) / max(float(g.abs().max()),
                                                  1e-30)
        for n, g in grads_p.items())
    # The f32 kernels sit a few ulp from the plain warp; cuDNN's backward
    # sums in an order that varies from run to run.
    if loss_rel > 1e-4 or grad_rel > 1e-3:
        raise AssertionError(f"kernel step vs plain step: loss {loss_rel:.2e}"
                             f" gradients {grad_rel:.2e}")
    return {"loss_rel": loss_rel, "grad_rel": grad_rel,
            "loss_kernels": aux_k["total"], "loss_plain": aux_p["total"]}


def check_history(name: str, history: list, steps: int, falls: bool
                  ) -> None:
    if len(history) != steps:
        raise AssertionError(f"[{name}] {len(history)} steps recorded for "
                             f"{steps}")
    if not all(math.isfinite(v) for h in history for v in h.values()):
        raise AssertionError(f"[{name}] a loss term is not finite")
    first = float(np.mean([h["offset"] for h in history[:5]]))
    last = float(np.mean([h["offset"] for h in history[-5:]]))
    log(f"  [{name}] {steps} steps: offset loss first five {first:.3e} -> "
        f"last five {last:.3e}; total {history[0]['total']:.3e} -> "
        f"{history[-1]['total']:.3e}")
    if falls and not last < first:
        raise AssertionError(f"[{name}] offset loss did not fall: "
                             f"{first:.3e} -> {last:.3e}")


def expect_launches(name: str, steps: int) -> dict:
    got = train_launches()
    log(f"  [{name}] kernel launches in {steps} steps: {got}")
    if any(v != steps for v in got.values()):
        raise AssertionError(f"[{name}] launches {got} for {steps} steps")
    return got


def phase_training(seed: int, work_dir: str):
    """train() at the full width of both shipped model configs, the resume
    check, and a fine-tune of the committed fast weights. Returns
    (per-run results, launches summed over the training runs, path of the
    fine-tuned .npz)."""
    results = {}
    launches = {k: 0 for k in train_launches()}
    for preset, steps in TRAIN_RUNS:
        _, mcfg = load_npz(os.path.join(ROOT, "checkpoints",
                                        dict(PRESETS)[preset]))
        half = steps // 2
        cfg = TrainConfig(model=mcfg, batch_size=TRAIN_BATCH, steps=steps,
                          learning_rate=TRAIN_LR, seed=seed,
                          checkpoint_every=half)
        ckpt_dir = os.path.join(work_dir, f"train_{preset}")
        history = []
        reset_train_launches()
        t0 = time.perf_counter()
        state = train_loop.train(cfg, checkpoint_dir=ckpt_dir, log_every=0,
                                 device="cuda", history=history)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k, v in expect_launches(preset, steps).items():
            launches[k] += v
        check_history(preset, history, steps, falls=True)
        if (ckpt_lib.latest_step(ckpt_dir) != steps
                or ckpt_lib.latest_train_state_step(ckpt_dir) != steps):
            raise AssertionError(f"[{preset}] no checkpoint at step {steps}")

        # Resume from the half-way record: the same losses as the
        # uninterrupted run (cuDNN's backward is not bit-reproducible, so
        # the runs drift apart by rounding).
        resumed = train_loop.load_train_state(cfg, ckpt_dir, device="cuda",
                                              step=half)
        history2 = []
        train_loop.train(cfg, state=resumed, log_every=0, history=history2)
        rel_first = abs(history2[0]["total"] - history[half]["total"]) \
            / history[half]["total"]
        rel_last = abs(history2[-1]["total"] - history[-1]["total"]) \
            / history[-1]["total"]
        log(f"  [{preset}] resumed at step {half}: loss "
            f"{history2[0]['total']:.6e} vs uninterrupted "
            f"{history[half]['total']:.6e} (rel {rel_first:.1e}); last step "
            f"rel {rel_last:.1e}")
        if len(history2) != steps - half or rel_first > 1e-4 \
                or rel_last > 0.05:
            raise AssertionError(f"[{preset}] resume differs: first "
                                 f"{rel_first:.1e}, last {rel_last:.1e}")

        step_check = kernels_vs_plain_step(state, cfg, steps)
        log(f"  [{preset}] one step through the kernels vs the plain "
            f"versions: loss rel {step_check['loss_rel']:.1e}, worst "
            f"gradient rel {step_check['grad_rel']:.1e}")
        results[preset] = {
            "steps": steps, "batch": TRAIN_BATCH, "wall_s": wall,
            "history": history, "resume_rel_first": rel_first,
            "resume_rel_last": rel_last, "kernels_vs_plain": step_check,
            "model_size": list(mcfg.model_size),
            "blocks_per_level": mcfg.blocks_per_level}
        del state, resumed

    # Overfit one fixed batch at the fast width: the gradients through the
    # loss warp's kernels point downhill (fresh batches for a few dozen
    # steps mostly show the warm-up transient).
    _, mcfg = load_npz(os.path.join(ROOT, "checkpoints",
                                    dict(PRESETS)["fast"]))
    cfg = TrainConfig(model=mcfg, batch_size=TRAIN_BATCH,
                      steps=OVERFIT_STEPS, learning_rate=TRAIN_LR, seed=seed,
                      checkpoint_every=0)
    state = train_loop.init_state(
        cfg, torch.Generator().manual_seed(seed), device="cuda")
    reset_train_launches()
    offs = [float(train_loop.train_step(
        state, train_loop.step_generator(seed, 0), cfg)["offset"])
        for _ in range(OVERFIT_STEPS)]
    for k, v in expect_launches("overfit fast", OVERFIT_STEPS).items():
        launches[k] += v
    last = float(np.mean(offs[-5:]))
    log(f"  [overfit fast] one batch, {OVERFIT_STEPS} steps: offset loss "
        f"{offs[0]:.3e} -> {last:.3e}")
    if not (math.isfinite(last) and last < 0.5 * offs[0]):
        raise AssertionError(f"overfit: offset loss {offs[0]:.3e} -> "
                             f"{last:.3e}")
    results["overfit_fast"] = {"steps": OVERFIT_STEPS, "offset": offs}
    del state

    # Fine-tune the committed fast weights for a few steps and export them.
    params, mcfg = load_npz(os.path.join(ROOT, "checkpoints",
                                         dict(PRESETS)["fast"]))
    cfg = TrainConfig(model=mcfg, batch_size=TRAIN_BATCH,
                      steps=FINETUNE_STEPS, learning_rate=2e-5, seed=seed + 1,
                      checkpoint_every=0)
    state = train_loop.build_state(cfg, params, device="cuda")
    history = []
    reset_train_launches()
    train_loop.train(cfg, state=state, log_every=0, history=history)
    torch.cuda.synchronize()
    for k, v in expect_launches("finetune fast", FINETUNE_STEPS).items():
        launches[k] += v
    check_history("finetune fast", history, FINETUNE_STEPS, falls=False)
    tuned = os.path.join(work_dir, "finetuned_fast.npz")
    ckpt_lib.export_npz(tuned, state.params, mcfg)
    results["finetune_fast"] = {"steps": FINETUNE_STEPS, "history": history}
    return results, launches, tuned


def phase_eval(seed: int, tuned_npz: str) -> dict:
    """evaluate_synthetic through the Stabilizer for the committed fast
    weights and the fine-tuned ones, on the same seeded clip."""
    out = {}
    h, w = EVAL_SIZE
    for name, path in (("committed fast", os.path.join(
            ROOT, "checkpoints", dict(PRESETS)["fast"])),
                       ("finetuned fast", tuned_npz)):
        params, mcfg = load_npz(path)
        stab = stab_lib.Stabilizer(
            StabilizeConfig(model=mcfg, chunk_frames=T_CHUNK), params,
            device="cuda")
        warp_wide.LAUNCHES = 0
        m = eval_lib.evaluate_synthetic(
            stab, torch.Generator().manual_seed(seed + 7), EVAL_FRAMES, h, w)
        log(f"  [{name}] {EVAL_FRAMES} frames {w}x{h}: psnr_vs_target "
            f"{m['psnr_vs_target']:.3f} dB, identity "
            f"{m['psnr_identity']:.3f} dB, gain {m['psnr_gain_db']:+.3f} "
            f"dB, stability_gain {m['stability_gain']:.3f} "
            f"({warp_wide.LAUNCHES} offsets-kernel launches)")
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"[{name}] eval report not finite: {m}")
        if warp_wide.LAUNCHES != math.ceil(EVAL_FRAMES / T_CHUNK):
            raise AssertionError(f"[{name}] {warp_wide.LAUNCHES} launches")
        out[name] = {k: float(v) for k, v in m.items()}
    if not out["committed fast"]["psnr_gain_db"] > 0:
        raise AssertionError("the committed fast weights gain no PSNR")
    return out


def phase_train_times(seed: int, results: dict) -> None:
    """Median ms of each part of a train step, and steps/s, per config."""
    for preset, _ in TRAIN_RUNS:
        _, mcfg = load_npz(os.path.join(ROOT, "checkpoints",
                                        dict(PRESETS)[preset]))
        cfg = TrainConfig(model=mcfg, batch_size=TRAIN_BATCH, steps=1000,
                          learning_rate=2e-4, seed=seed)
        state = train_loop.init_state(
            cfg, torch.Generator().manual_seed(seed), device="cuda")
        model, dev = state.model, torch.device("cuda", 0)
        mh, mw = mcfg.model_size
        n = mcfg.window
        names = ("data_generation", "forward", "loss_warp", "backward",
                 "optimizer")
        rows = []
        for it in range(23):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            state.optimizer.zero_grad(set_to_none=True)
            ev[0].record()
            batch = train_loop.render_batch(*train_loop.draw_batch(
                train_loop.step_generator(seed, it), cfg, None, dev), cfg)
            ev[1].record()
            in_frames, lasts, t_frames, t_offs = batch
            b, s = lasts.shape[:2]
            feats = motion_cnn.encode_frames(model, in_frames.flatten(0, 1))
            feats = feats.reshape(b, in_frames.shape[1], *feats.shape[1:])
            fwins = torch.stack([feats[:, k:k + n] for k in range(s)], dim=1)
            offsets = motion_cnn.offsets_from_feature_windows(
                model, fwins.flatten(0, 1))
            ev[2].record()
            grids = grid_ops.grid_from_offsets(offsets, mh, mw)
            warped = warp_ops.warp_batch_diff(lasts.flatten(0, 1), grids)
            loss = ((warped - t_frames.flatten(0, 1)) ** 2).mean() \
                + 10.0 * ((offsets - t_offs.flatten(0, 1)) ** 2).mean()
            ev[3].record()
            loss.backward()
            ev[4].record()
            state.optimizer.step()
            state.scheduler.step()
            ev[5].record()
            torch.cuda.synchronize()
            if it >= 3:                              # warm
                rows.append([ev[i].elapsed_time(ev[i + 1])
                             for i in range(5)])
        parts = dict(zip(names, np.median(np.array(rows), axis=0).tolist()))
        walls = []
        for it in range(23):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_loop.train_step(state, train_loop.step_generator(
                seed, 100 + it), cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        step_ms = 1e3 * float(np.median(walls[3:]))
        log(f"  [{preset}] train step (batch {TRAIN_BATCH}, {mw}x{mh}, "
            f"medians of 20): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
            + f"; whole step {step_ms:.4f} ms = {1e3 / step_ms:.2f} steps/s"
            f" = {1e3 * TRAIN_BATCH / step_ms:.1f} samples/s")
        results[preset].update({"step_part_ms": parts, "step_ms": step_ms,
                                "steps_per_s": 1e3 / step_ms,
                                "samples_per_s":
                                    1e3 * TRAIN_BATCH / step_ms})


def time_dense_kernels(rng, dev) -> dict:
    """Each dense-grid kernel alone at its path's shape (quality width:
    64 rendered frames and 16 loss frames of 256^2 x 3; one 720p chunk
    for the uint8 kernel), beside its bound, its plain version and
    F.grid_sample."""
    recs = {}

    def lib(src_nchw, grids):
        return F.grid_sample(src_nchw, grids, mode="bilinear",
                             padding_mode="border", align_corners=True)

    # warp_f32: the data-generation warp, B = 64.
    b, h, w, c = 64, 256, 256, 3
    frames = torch.from_numpy(rng.random((b, h, w, c), dtype=np.float32)
                              ).to(dev)
    grids = smooth_grids(rng, b, h, w, 1.0, dev)
    frames64, grids64 = frames, grids
    nchw = frames.permute(0, 3, 1, 2).contiguous()
    n_pix = b * h * w
    bound_ms, by = bound(4 * (frames.numel() + grids.numel() + n_pix * c),
                         n_pix * (20 + 6 * c))
    recs["warp_f32"] = {
        "ms": median_ms(lambda: warp_bilinear.bilinear_warp_batch(
            frames, grids)),
        "plain_ms": median_ms(
            lambda: warp_bilinear.bilinear_warp_batch_plain(frames, grids)),
        "library_ms": median_ms(lambda: lib(nchw, grids)),
        "bound_ms": bound_ms, "bound_by": by, "shape": [b, h, w, c]}

    # The loss warp, B = 16: forward with derivative images, and backward.
    b = 16
    frames, grids, nchw = frames[:b].contiguous(), grids[:b].contiguous(), \
        nchw[:b].contiguous()
    grids16 = grids
    n_pix = b * h * w
    cot = torch.from_numpy(rng.standard_normal(
        (b, h, w, c)).astype(np.float32)).to(dev)
    _, dximg, dyimg = warp_bilinear.warp_diff_forward(frames, grids)
    bound_ms, by = bound(4 * (frames.numel() + grids.numel()
                              + 3 * n_pix * c), n_pix * (20 + 14 * c))
    recs["warp_f32_diff_fwd"] = {
        "ms": median_ms(lambda: warp_bilinear.warp_diff_forward(
            frames, grids)),
        "plain_ms": median_ms(
            lambda: warp_bilinear.warp_diff_forward_plain(frames, grids)),
        "library_ms": median_ms(lambda: lib(nchw, grids)),
        "bound_ms": bound_ms, "bound_by": by, "shape": [b, h, w, c]}
    g_req = grids.clone().requires_grad_()
    lib_out = lib(nchw, g_req)
    cot_nchw = cot.permute(0, 3, 1, 2).contiguous()
    bound_ms, by = bound(4 * (3 * n_pix * c + 2 * grids.numel()),
                         n_pix * (10 + 4 * c))
    recs["warp_f32_diff_bwd"] = {
        "ms": median_ms(lambda: warp_bilinear.warp_diff_backward(
            cot, dximg, dyimg, grids, h, w)),
        "plain_ms": median_ms(
            lambda: warp_bilinear.warp_diff_backward_plain(
                cot, dximg, dyimg, grids, h, w)),
        "library_ms": median_ms(lambda: torch.autograd.grad(
            lib_out, g_req, cot_nchw, retain_graph=True)),
        "bound_ms": bound_ms, "bound_by": by, "shape": [b, h, w, c]}
    del lib_out, g_req

    # warp_u8_batch: one 720p chunk through a dense grid.
    b, h, w, c = T_CHUNK, HEIGHT, WIDTH, 3
    frames8 = torch.from_numpy(
        rng.integers(0, 256, (b, h, w, c), dtype=np.uint8)).to(dev)
    grids = smooth_grids(rng, b, h, w, 1.0, dev)
    nchw = frames8.permute(0, 3, 1, 2).to(torch.float32).contiguous()
    n_pix = b * h * w
    bound_ms, by = bound(2 * frames8.numel() + 4 * grids.numel(),
                         n_pix * (20 + 10 * c))
    recs["warp_u8_batch"] = {
        "ms": median_ms(lambda: warp_wide.warp_u8_batch(frames8, grids)),
        "plain_ms": median_ms(
            lambda: warp_wide.warp_u8_batch_plain(frames8, grids), iters=10),
        "library_ms": median_ms(lambda: lib(nchw, grids)),
        "bound_ms": bound_ms, "bound_by": by, "shape": [b, h, w, c]}
    warm = {
        "warp_f32": lambda: warp_bilinear.bilinear_warp_batch(
            frames64, grids64),
        "warp_f32_diff_fwd": lambda: warp_bilinear.warp_diff_forward(
            frames, grids16),
        "warp_f32_diff_bwd": lambda: warp_bilinear.warp_diff_backward(
            cot, dximg, dyimg, grids16, 256, 256),
        "warp_u8_batch": lambda: warp_wide.warp_u8_batch(frames8, grids),
    }
    for name, fn in warm.items():
        recs[name]["warm_l2_ms"] = median_ms(fn, cold=False)
    for name, r in recs.items():
        log(f"  {name} {r['shape']}: {r['ms']:.4f} ms from a cold L2 "
            f"({r['warm_l2_ms']:.4f} ms back to back); bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); plain "
            f"{r['plain_ms']:.4f} ms; F.grid_sample "
            f"{r['library_ms']:.4f} ms")
    return recs


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
    build_each = _build.build(SOURCES)
    build_s = time.perf_counter() - t0
    log(f"built and loaded {len(SOURCES)} sources concurrently in "
        f"{build_s:.2f} s: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in build_each.items()))

    log("== phase 2: kernels against their plain versions")
    rng = np.random.default_rng(args.seed)
    max_lsb = phase_kernel_checks(rng, dev)
    worst = phase_dense_kernel_checks(rng, dev)

    log("== phase 3: stabilize path, both presets, 1280x720")
    launches, launches_dense, results, stabs, clip = phase_main_path(
        args.seed, dev)

    log("== phase 4: times of the stabilize path")
    b1 = phase_times(stabs, clip, dev, results)
    del stabs, clip

    log("== phase 5: training path at full width, then eval")
    with tempfile.TemporaryDirectory() as work_dir:
        train_results, train_counts, tuned = phase_training(args.seed,
                                                            work_dir)
        eval_results = phase_eval(args.seed, tuned)

    log("== phase 6: times of the training path and of each kernel")
    phase_train_times(args.seed, train_results)
    dense = time_dense_kernels(rng, dev)

    def entry(name, source, replaces, n_launches, err, rec):
        return {"name": name, "route": "cuda",
                "source": f"dvsg_tpu_torch/csrc/{source}.cu",
                "replaces": replaces, "launches": n_launches,
                "max_abs_err": err, "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"]}

    pallas = "dvsg_tpu/ops/warp_pallas.py"
    kernels = [
        entry("warp_u8_offsets", "warp_u8_offsets",
              "dvsg_tpu/ops/warp_wide.py:767", launches, max_lsb, b1),
        entry("warp_f32", "warp_bilinear", f"{pallas}:315",
              train_counts["warp_f32"], worst["warp_f32"],
              dense["warp_f32"]),
        entry("warp_f32_diff_fwd", "warp_bilinear", f"{pallas}:407",
              train_counts["warp_f32_diff_fwd"],
              worst["warp_f32_diff_fwd"], dense["warp_f32_diff_fwd"]),
        entry("warp_f32_diff_bwd", "warp_bilinear", f"{pallas}:421",
              train_counts["warp_f32_diff_bwd"],
              worst["warp_f32_diff_bwd"], dense["warp_f32_diff_bwd"]),
        entry("warp_u8_batch", "warp_u8_batch",
              "dvsg_tpu/ops/warp_wide.py:593", launches_dense,
              worst["warp_u8_batch"], dense["warp_u8_batch"]),
    ]
    if any(k["launches"] < 1 for k in kernels):
        raise AssertionError(f"a kernel was never launched on its path: "
                             f"{[(k['name'], k['launches']) for k in kernels]}")
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "seed": args.seed,
              "kernels": kernels, "b1": b1, "dense_kernels": dense,
              "presets": results, "training": train_results,
              "eval": eval_results, "build_s": build_s,
              "build_each_s": build_each,
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
