#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``dvsg_tpu_torch``).

    python3 chip_smoke.py [--seed 0]

Needs one CUDA card (cuda:0), nvcc and the repository's sources; exits
non-zero without a card or outside the repository. Phase 12 uses every
visible card (four at most). Phases, each raising
on failure:

1. card, power limit and versions; build every kernel with nvcc, one
   process per source, started together; registers and spills of every
   kernel as ptxas reports them;
2. each kernel against its plain PyTorch version on the card, at its main
   path's shapes and at edge shapes: the uint8 kernels within 1 LSB (both
   offsets kernels, each on the shapes the wrapper sends it, and the
   general-shape one also on the packed kernel's), the f32 warps within
   1e-5, the grid gradient within 1e-4 of the largest gradient; both
   dense-grid uint8 kernels on the packed kernel's shapes, byte-equal;
   the bf16 GELU kernels byte-equal to the op chain on every bf16 value;
3. the stabilize path, ``Stabilizer.stabilize_clip`` with T = 16 on a
   seeded 48-frame 1280x720 shaky clip, for both shipped presets at full
   width and depth: output shape and dtype, one launch of the packed
   offsets kernel per chunk,
   ``stabilize_stream`` with a resume record byte-identical to the clip
   path, the card within 1 LSB of the CPU path on a small clip, a positive
   PSNR gain, and the same chunk through ``warp_quantize_batch(grids=...)``
   (the packed dense-grid kernel, one launch) within 1 LSB of the offsets
   kernel;
4. times of that path with CUDA events after warm-up: each chunk stage,
   the device chunk, end-to-end frames/s, where a stream's host time goes;
5. path smoothing, auto-crop, online and overlap, both presets, 1280x720,
   on a seeded 96-frame sway clip (sinusoidal x/y sway, periods 40 and 56
   frames, plus jitter): causal (``path_smooth=32``) and fixed-lag
   (``path_smooth_lag=16``) ``stabilize_clip`` with one packed offsets
   kernel launch per chunk; stream == clip; a stream resumed mid-stream
   and (lag) in the drain region == the uninterrupted one; the card
   within 1 LSB of the CPU path on a small sway clip; the residual
   translation path (RMS of the cumulative measured shifts of the output)
   under 0.75x the unsmoothed output's; PSNR against the ideal target
   higher smoothed than unsmoothed; ``pick_border_crop``'s crop keeping
   every applied coordinate in [-1, 1]; ``OnlineStabilizer`` == clip;
   the overlapped stream == the sync stream; no host synchronization in
   either smoothed chunk step (``set_sync_debug_mode("error")``); then the
   stage times of the smoothed chunks and the overlapped stream against
   the sync stream;
6. the training path, ``train.loop.train`` from a seeded init at the full
   width of both shipped model configs (batch 8, window 5) and a fine-tune
   of the committed ``fast`` weights: finite losses, the offset loss
   falling (and falling by half on one fixed batch), one launch of each
   training kernel per step, one step's loss
   and parameter gradients through the kernels equal to the same step
   through the plain versions, a checkpoint saved, reloaded and resumed at
   the uninterrupted run's loss; then ``evaluate_synthetic`` of the
   committed and the fine-tuned weights;
7. times of a train step (data generation, forward, loss warp, backward,
   optimizer; medians of 20) and of each kernel beside its bound, its
   plain version and ``F.grid_sample`` (timed here as a yardstick only;
   the port never calls it): medians of 20 single calls from a cold L2,
   queued behind a long kernel. The two offsets kernels, the two
   dense-grid uint8 kernels and the stage variants of each pair (each
   strips one part of a kernel) are timed in turns, beside their SASS
   lengths; the bf16 GELU kernels at the quality stem's training shape,
   byte-equal to the op chain there (both outputs, bf16, f32 and
   channels-last cotangents), timed beside the op chain and ``F.gelu``'s
   tanh form (yardstick only); the bf16 GroupNorm kernels at the quality
   level-0 training shape, the forward within one bf16 step of the op
   chain there, both timed beside the chain and aten's ``group_norm``
   (yardstick only);
8. batch and serve, both presets, 1280x720: four seeded clips of 48, 40,
   33 and 17 frames from four threads at once through ``BatchStabilizer``
   (plain, causal, lag; one group), and through ``stabilize_multi``
   (plain, causal), each clip byte-equal to ``stabilize_clip`` with one
   offsets-kernel launch per batched chunk; every clip of eight byte-equal
   in batches of 1, 2, 4 and 8 and alone, and at T = 8 against 16 (plain,
   causal, lag); the batched step's times per chunk at B = 1, 2, 4, 8,
   back to back and queued, and its peak memory at B = 8; eight 48-frame
   clips end to end through ``stabilize_multi`` beside one after another
   through the sync stream; and where OpenCV imports, one mp4 POSTed to a
   localhost server (``dvsg_tpu_torch/serve.py``) whose response equals
   the single-clip output, encoded;
9. parallel and export, both presets, 1280x720, T = 16, four seeded
   48-frame clips: (a) a world of one rank over NCCL on cuda:0:
   ``ShardedClipStabilizer`` (plain, causal, lag) and
   ``TemporalShardedStabilizer`` (plain, causal) byte-equal to
   ``stabilize_clip`` with one offsets-kernel launch per (batched) chunk,
   and ``make_dp_train_step`` equal to ``train_step`` to the last bit over
   two steps (cuDNN's deterministic algorithms), one B2 and one B3 pair a
   step; (b) two ranks sharing cuda:0 over gloo, spawned: temporal (plain,
   causal) and clip-sharded (plain) byte-equal to one process on every
   rank, the DP step within 1e-6 of the parameters and 1e-5 of the loss;
   (c) the chunk step exported (``export.py``), saved, loaded and run over
   the clip (plain, causal), byte-equal to ``stabilize_clip`` with one
   launch per chunk through the artifact, and a ``fast`` batch artifact of
   four clips byte-equal to the live batched step; (d) the artifact's
   chunk against the live chunk, back to back and queued, export seconds
   and artifact bytes, the temporal chunk end to end on one and two
   ranks, the DP step against ``train_step``;
10. bf16 compute, the stacked arch and the profiler: (a) bf16 at both
   presets' full width, 1280x720, T = 16, committed weights, on a seeded
   32-frame clip: one launch a chunk; the first chunk's offsets against
   the CPU port's bf16 within ``BF16_GAP_SHARE`` of the card's own bf16-
   to-f32 gap; frames against the CPU port's bf16 on a small clip (share
   beyond 1 LSB recorded); byte identity at T = 8 against 16, in a batch
   of 2 against 1, and resumed; an exported bf16 artifact byte-equal to
   the live path; chunk (back to back and queued) and encoder (queued) ms,
   f32 and bf16 in turns, and one chunk of each profiled (the elementwise
   kernels' share); eval gain > 0 (``fast``); (b) bf16 ``fast`` at
   1920x1080, a device-resident chain of 24 chunks: no drift between the
   first and last quarter, the last quarter's peak memory not above the
   first quarter's, the output not flat; (c) the stacked arch at both
   presets' widths from a seeded init: 20 train steps at batch 8 (one B2
   and one B3 pair a step, the kernel step against the plain step, the
   step's time), then stabilize (chunk ms back to back and queued) with
   one launch a chunk, within 1 LSB of the CPU path, and an exported
   stacked artifact byte-equal to the live path; (d) bf16 training at both
   presets' widths, batch 8: steps/s, finite losses, each GELU kernel
   launched once a GELU call and each GroupNorm kernel twice a ResBlock
   of every step, the kernel step against the plain step (plain warps,
   plain GELU and GroupNorm chains); (e) ``stabilize --profile-dir``'s trace and
   ``[profile]`` lines around the ``fast`` sync and overlapped streams of
   the 720p clip: B1's packed kernel once a chunk in the trace, the top
   eight ops, each stream's device idle share (a 96-frame clip);
11. staging, export for the card without one, tensor parallelism,
   examples, quality table: (a) the host staging extension
   (``utils/staging.py``) byte-equal to the plain numpy swap on a
   16x720x1280x3 chunk, host times of both (medians of 20 in turns) beside
   the host's CPU and core count, a ``StagingRing`` slot filled and
   uploaded to the card; (b) both presets exported for the card at
   1280x720, T = 16, by a process that sees no card (``export
   --for-platform cuda``), loaded on cuda:0: frames byte-equal to
   ``stabilize_clip`` with one launch a chunk, the artifact's queued chunk
   time beside the live chunk's; (c) tensor parallelism: two gloo ranks
   sharing cuda:0 on a (1, 2) ("data", "model") mesh, both presets at full
   width: offsets within 2e-5 of the unsharded model, a 720p chunk through
   ``TPStabilizer`` within 1 LSB of ``stabilize_clip`` with one launch, its
   time against unsharded; (d) every example of ``examples/torch`` as a
   subprocess on cuda, all together, each printing its line (those that
   need OpenCV only where it imports); (e) where OpenCV imports, the
   quality table's sway and handheld rows on the card, held to the gates
   of tests/test_torch_quality_table.py;
12. the multi-rank surfaces over NCCL, one rank per card: 4 ranks where
   the machine has four cards or more, 2 where it has two or three; with
   one card a line says that the phase did not run, and nothing runs in
   its place. Both presets, 1280x720, T = 16, every gate held against this
   one process on cuda:0: (a) eight seeded 48-frame clips, two a rank on
   four cards, through ``ShardedClipStabilizer`` (plain, causal, lag) and
   ``stabilize_multi(mesh=)`` (plain, causal; each rank writes its own
   clips), byte-equal to ``stabilize_clip``, one B1 launch per batched
   chunk per rank; frames/s against the same batch on one card, each
   rank's device idle share; (b) a seeded 96-frame clip through
   ``TemporalShardedStabilizer`` (plain, causal) at T = 16 (four local
   frames a rank: the halo-equal boundary) and T = 64, byte-equal, one
   launch a chunk a rank; the chunk's ms against one card and the ms
   inside ``mesh.ring_shift`` and ``mesh.all_gather`` (CUDA events); (c)
   ``make_dp_train_step`` at batch 8, f32, 10 steps under cuDNN's
   deterministic algorithms: every loss within rtol 1e-5 of
   ``train_step``, the first step's parameters within 1e-6 and gradients
   within 1e-3 of each tensor's largest, a second run byte-equal to the
   first on every rank, every rank's parameters equal, one B2 and one B3
   pair a step a rank; steps/s against one card; (d) tensor parallelism on
   (1, n) and (2, n/2) ("data", "model") meshes: offsets within 2e-5 of one
   process, a chunk within 1 LSB of ``stabilize_clip``, one launch a rank,
   the chunk's ms and the ms inside ``tp.gather_channels``; (e) ``python
   -m dvsg_tpu_torch.parallel.dryrun n`` over NCCL, one rank a card, and,
   where OpenCV imports, ``stabilize-batch`` under ``torchrun`` over four
   seeded mp4s byte-equal to the same command with ``--no-mesh``, each
   rank writing its own clip on its own card.
13. the reference's argv and ``predict_grid``: (a)
   ``models.motion_cnn.predict_grid`` for both presets at full width,
   grids at 1280x720: bit-equal to ``grid_from_offsets(predict_offsets)``
   on the card, within 1e-4 of the CPU path; (b) where OpenCV imports, on
   a seeded 48-frame 720p mp4 through ``cli.main``: ``stabilize
   --checkpoint flagship_fast.npz --preset quality --chunk-frames 0``
   byte-equal to ``--preset fast --chunk-frames 16``, one packed B1
   launch a chunk; ``eval --warp-impl auto --chunk-frames 0`` (its
   launches logged); ``export --checkpoint ... --preset quality
   --warp-impl auto --for-platform cuda``, then ``stabilize --artifact``
   byte-equal to the live run; ``eval --warp-impl pallas`` exits 2.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. ``--json PATH`` also writes every
measured number there.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import hashlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from dvsg_tpu_torch.config import StabilizeConfig, TrainConfig
from dvsg_tpu_torch.models import motion_cnn
from dvsg_tpu_torch.ops import _build, bf16_round
from dvsg_tpu_torch.ops import grid as grid_ops
from dvsg_tpu_torch.ops import resize as resize_ops
from dvsg_tpu_torch.ops import warp as warp_ops
from dvsg_tpu_torch.ops import warp_bilinear, warp_ref, warp_wide
from dvsg_tpu_torch.parallel import dp
from dvsg_tpu_torch.pipeline import autocrop, pathsmooth
from dvsg_tpu_torch.pipeline import stabilize as stab_lib
from dvsg_tpu_torch.pipeline.batching import BatchStabilizer
from dvsg_tpu_torch.pipeline.multiclip import stabilize_multi
from dvsg_tpu_torch.pipeline.online import OnlineStabilizer
from dvsg_tpu_torch.pipeline.overlap import stabilize_stream_overlapped
from dvsg_tpu_torch.train import eval as eval_lib
from dvsg_tpu_torch.train import loop as train_loop
from dvsg_tpu_torch.train import synthetic
from dvsg_tpu_torch.utils import checkpoint as ckpt_lib
from dvsg_tpu_torch.utils.checkpoint import load_npz
from dvsg_tpu_torch.utils.metrics import StageTimer, psnr

ROOT = os.path.dirname(os.path.abspath(__file__))
PRESETS = (("fast", "flagship_fast.npz"), ("quality", "flagship.npz"))
SOURCES = ("warp_u8_offsets", "warp_bilinear", "warp_u8_batch",
           "bf16_round")                                   # csrc/
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
# Path smoothing phase: sway clip length, EMA horizon, lag, and the small
# clip (frames, height, width) held against the CPU path.
SWAY_FRAMES, SMOOTH, LAG = 96, 32, 16
SMALL_SWAY = (24, 180, 320)
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


def sass_counts(name: str) -> dict:
    """Instructions (NOP padding left out) in the SASS of every kernel of
    one built source, by cuobjdump; empty where the toolkit has none."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", _build._target(name)[1]],
                          check=True, capture_output=True, text=True,
                          timeout=120).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?(\w+)", part)
        counts[part.split()[0]] = sum(op != "NOP" for op in ops)
    return counts


def build_report() -> list:
    """One line per kernel this process compiled: the stack frame and
    spills, the registers and memory it uses, as ptxas printed them, and
    the length of its SASS."""
    lines, entry, frame = [], None, ""
    for name, text in _build.PTXAS_LOG.items():
        sass = sass_counts(name)
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry, frame = line.split("'")[1], ""
            elif "bytes stack frame" in line:
                frame = line.strip()
            elif "Used" in line and entry:
                # <digit>kernel_name[ILi<stage>E] inside the mangled name
                short = re.search(r"\d((?:warp|gelu|gn)_[a-z0-9_]*?_kernel)"
                                  r"(?:ILi(\d+)E)?", entry)
                kernel = entry if not short else short[1] + (
                    f"<{short[2]}>" if short[2] else "")
                lines.append(f"{kernel}: {frame}; "
                             f"{line.split(':', 1)[1].strip()}; "
                             f"{sass.get(entry, 'unknown')} SASS "
                             f"instructions")
                entry = None
    return lines


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
        # Outside inference mode, whoever asks first: the flush writes in
        # place, which an inference tensor refuses elsewhere.
        with torch.inference_mode(False):
            _scratch["a"] = torch.randn(6144, 6144, device=dev)
            _scratch["l2"] = torch.empty(96 * 1024 * 1024,
                                         dtype=torch.uint8, device=dev)
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


def time_in_turns(turns) -> dict:
    """Median ms (``median_ms``) of each (name, fn) of ``turns``, in order
    and then the first two again in reverse (A, B, ..., B, A): name →
    list of readings."""
    in_turns = {}
    for name, fn in [*turns, *turns[1::-1]]:
        in_turns.setdefault(name, []).append(median_ms(fn))
    return in_turns


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
    """In-memory reader with the VideoReader methods the streams use."""

    def __init__(self, frames: np.ndarray):
        self.frames, self.pos = frames, 0
        self.height, self.width = frames.shape[1:3]

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
                 ((2, 33, 257, 4), (61, 300), 2.0),
                 ((2, 40, 152, 3), (36, 100), 1.4))


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
        o_k = warp_bilinear.warp_diff_forward(frames, grids)
        dg_k = warp_bilinear.warp_diff_backward(cot, frames, grids)
        dg_p = warp_bilinear.warp_diff_grid_grad_plain(cot, frames, grids)
        # Through autograd: the same kernels, and nothing kept for the
        # backward but the frames and the grids.
        g_req = grids.clone().requires_grad_()
        o_a = warp_bilinear.bilinear_warp_batch_grids_diff(frames, g_req)
        kept = sorted(tuple(t.shape) for t in o_a.grad_fn.saved_tensors)
        o_a.backward(cot)
        torch.cuda.synchronize()
        e_warp = float((out_k - out_p).abs().max())
        e_val = max(float((o_k - out_p).abs().max()),
                    float((o_a.detach() - out_p).abs().max()))
        e_bwd = max(float((dg_k - dg_p).abs().max()),
                    float((g_req.grad - dg_p).abs().max()))
        g_max = float(dg_p.abs().max())
        held = float(((dg_p == 0).all(dim=-1)).float().mean())
        log(f"  warp_f32 {shape} -> {ho}x{wo} spill {spill}: value "
            f"{e_warp:.2e}; diff fwd value {e_val:.2e}; diff bwd "
            f"{e_bwd:.2e} of max |dgrid| {g_max:.1f} ({held:.3f} of pixels "
            f"fully masked)")
        if e_warp > 1e-5 or e_val > 1e-5:
            raise AssertionError(f"f32 warp value off by {e_warp:.2e} / "
                                 f"{e_val:.2e} at {shape}")
        if e_bwd > 1e-4 * max(g_max, 1.0):
            raise AssertionError(f"grid gradient off by {e_bwd:.2e} of "
                                 f"{g_max:.1f} at {shape}")
        if kept != sorted([tuple(frames.shape), tuple(grids.shape)]):
            raise AssertionError(f"the forward kept {kept} for its backward")
        worst["warp_f32"] = max(worst["warp_f32"], e_warp)
        worst["warp_f32_diff_fwd"] = max(worst["warp_f32_diff_fwd"], e_val)
        worst["warp_f32_diff_bwd"] = max(worst["warp_f32_diff_bwd"], e_bwd)
    u8_cases = (((T_CHUNK, HEIGHT, WIDTH, 3), (HEIGHT, WIDTH), 1.0),
                *U8_EDGE_CASES)
    for shape, (ho, wo), spill in u8_cases:
        frames = torch.from_numpy(
            rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        grids = smooth_grids(rng, shape[0], ho, wo, spill, dev)
        packed = warp_wide.takes_packed_batch_kernel(shape, grids.shape)
        pick = "packed" if packed else "general"
        before = warp_wide.LAUNCHES_BATCH, warp_wide.LAUNCHES_BATCH_PACKED
        outs = {pick: warp_wide.warp_u8_batch(frames, grids)}
        if (warp_wide.LAUNCHES_BATCH - before[0],
                warp_wide.LAUNCHES_BATCH_PACKED - before[1]) \
                != (1, int(packed)):
            raise AssertionError(f"{shape} did not take the {pick} "
                                 f"dense-grid kernel")
        if packed:
            outs["general"] = warp_wide._launch_batch(frames, grids,
                                                      packed=False)
        out_p = warp_wide.warp_u8_batch_plain(frames, grids)
        torch.cuda.synchronize()
        for name, out_k in outs.items():
            diff = (out_k.to(torch.int16) - out_p.to(torch.int16)).abs()
            maxd = int(diff.max())
            share = float((diff > 0).float().mean())
            log(f"  warp_u8_batch[{name}] {shape} -> {ho}x{wo} spill "
                f"{spill}: max |diff| {maxd} LSB, {share:.3e} of values "
                f"differ")
            if maxd > 1:
                raise AssertionError(f"warp_u8_batch {name} kernel differs "
                                     f"from plain by {maxd} LSB at {shape}")
            worst["warp_u8_batch"] = max(worst["warp_u8_batch"], maxd)
        if packed and not torch.equal(outs["packed"], outs["general"]):
            raise AssertionError(f"the packed and the general dense-grid "
                                 f"kernels differ at {shape}")
    return worst


# Offsets-kernel checks: (frames shape, offset grid, amplitude, crop). The
# first is the stabilize path's chunk; widths that are no multiple of four
# and C != 3 go to the general-shape kernel; +-1.5 leaves the frame on
# every side.
B1_CASES = (((T_CHUNK, HEIGHT, WIDTH, 3), (16, 16), 0.2, 0.0),
            ((T_CHUNK, HEIGHT, WIDTH, 3), (16, 16), 0.2, 0.05),
            ((4, HEIGHT, WIDTH, 3), (16, 16), 1.5, 0.0),
            ((2, HEIGHT, WIDTH, 3), (8, 8), 0.2, 0.03),
            ((2, HEIGHT, WIDTH, 3), (32, 32), 0.2, 0.0),
            ((3, 96, 132, 3), (5, 7), 1.5, 0.1),
            ((T_CHUNK, 480, 854, 3), (16, 16), 0.2, 0.0),
            ((T_CHUNK, 480, 854, 3), (16, 16), 0.2, 0.05),
            ((3, 97, 131, 3), (16, 16), 1.5, 0.0),
            ((2, 360, 640, 1), (16, 16), 0.2, 0.0),
            ((2, 360, 640, 4), (8, 8), 0.2, 0.05))


def phase_kernel_checks(rng, dev) -> int:
    """Both offsets kernels against the plain version: the wrapper's pick
    on every case, and the general-shape kernel also on the packed
    kernel's shapes. Returns the max |diff| in LSB."""
    worst = 0
    for shape, grid, amp, crop in B1_CASES:
        frames = torch.from_numpy(
            rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        offs = torch.from_numpy(rng.uniform(
            -amp, amp, (shape[0], *grid, 2)).astype(np.float32)).to(dev)
        packed = warp_wide.takes_packed_kernel(shape)
        pick = "packed" if packed else "general"
        before = warp_wide.LAUNCHES, warp_wide.LAUNCHES_PACKED
        outs = {pick: warp_wide.warp_u8_offsets(frames, offs, crop)}
        if (warp_wide.LAUNCHES - before[0],
                warp_wide.LAUNCHES_PACKED - before[1]) != (1, int(packed)):
            raise AssertionError(f"{shape} did not take the {pick} kernel")
        if packed:
            outs["general"] = warp_wide._launch(
                frames, warp_wide.offset_rows(offs, shape[1]), crop,
                packed=False)
        out_p = warp_wide.warp_u8_offsets_plain(frames, offs, crop)
        torch.cuda.synchronize()
        if packed:
            n_apart = int((outs["packed"] != outs["general"]).sum())
            log(f"  warp_u8_offsets {shape}: packed vs general kernel, "
                f"{n_apart} bytes differ")
        for name, out_k in outs.items():
            diff = (out_k.to(torch.int16) - out_p.to(torch.int16)).abs()
            maxd = int(diff.max())
            share = float((diff > 0).float().mean())
            log(f"  warp_u8_offsets[{name}] {shape} grid {grid} offsets "
                f"±{amp} crop {crop}: max |diff| {maxd} LSB, {share:.3e} "
                f"of values differ")
            if maxd > 1:
                raise AssertionError(f"{name} kernel differs from plain by "
                                     f"{maxd} LSB at {shape}, crop {crop}")
            worst = max(worst, maxd)
    return worst


def phase_gelu_checks(rng, dev) -> int:
    """Both bf16 GELU kernels against the plain op chain on the card, byte
    for byte: every bf16 value (forward with bf16 and f32 output, backward
    with a bf16 and an f32 cotangent), and the vector loop's ragged end and
    a view off the 16-byte boundary. Returns the values that differ (0)."""
    every = torch.arange(-32768, 32768, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16).to(dev)
    ragged = (torch.from_numpy(rng.normal(0, 2.0, (1 << 20) + 5).astype(
        np.float32)).to(dev).bfloat16())
    differ = 0
    for name, x in (("every bf16 value", every), ("2^20 + 5", ragged),
                    ("view off 16 bytes", ragged[1:])):
        g = torch.from_numpy(rng.normal(0, 1.0, x.numel()).astype(
            np.float32)).to(dev)
        pairs = {
            "fwd": (bf16_round.gelu_bf16(x, False),
                    bf16_round.gelu_plain(x, False)),
            "fwd f32_out": (bf16_round.gelu_bf16(x, True),
                            bf16_round.gelu_plain(x, True)),
            "bwd": (bf16_round.gelu_bf16_bwd(x, g.bfloat16()),
                    bf16_round.gelu_grad_plain(x, g.bfloat16())),
            "bwd f32 g": (bf16_round.gelu_bf16_bwd(x, g),
                          bf16_round.gelu_grad_plain(x, g)),
        }
        for kind, (got, want) in pairs.items():
            n = gelu_values_differ(got, want)
            log(f"  gelu_bf16 {kind}, {name} ({x.numel()}): {n} values "
                f"differ from the op chain")
            differ += n
    if differ:
        raise AssertionError(f"the bf16 GELU kernels differ from the op "
                             f"chain on {differ} values")
    return differ


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

        warp_wide.LAUNCHES = warp_wide.LAUNCHES_PACKED = 0
        out = stab.stabilize_clip(clip)
        torch.cuda.synchronize()
        n, n_packed = warp_wide.LAUNCHES, warp_wide.LAUNCHES_PACKED
        launches += n
        log(f"  [{preset}] stabilize_clip {clip.shape}: {n} kernel "
            f"launches ({n_packed} of the packed kernel) for {n_chunks} "
            f"chunks")
        if out.shape != clip.shape or out.dtype != np.uint8:
            raise AssertionError(f"output {out.shape} {out.dtype}")
        if n != n_chunks or n_packed != n_chunks:
            raise AssertionError(f"{n} launches, {n_packed} of the packed "
                                 f"kernel, for {n_chunks} chunks")

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
            warp_wide.LAUNCHES_BATCH = warp_wide.LAUNCHES_BATCH_PACKED = 0
            dense = warp_ops.warp_quantize_batch(frames, grids=grids)
            torch.cuda.synchronize()
            n_dense = warp_wide.LAUNCHES_BATCH
            n_dense_packed = warp_wide.LAUNCHES_BATCH_PACKED
        launches_dense += n_dense
        dense_lsb = int((dense.to(torch.int16)
                         - b1_out.to(torch.int16)).abs().max())
        log(f"  [{preset}] warp_quantize_batch(grids=) on the first chunk: "
            f"{n_dense} launch ({n_dense_packed} of the packed kernel), max "
            f"{dense_lsb} LSB from the offsets kernel")
        if n_dense != 1 or n_dense_packed != 1 or dense_lsb > 1:
            raise AssertionError(f"dense-grid path: {n_dense} launches, "
                                 f"{n_dense_packed} of the packed kernel, "
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
                           "dense_vs_offsets_max_lsb": dense_lsb,
                           "dense_packed_launches": n_dense_packed}
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


# Stage variants of the two offsets kernels, (packed, stage, name): what
# each leaves out of its kernel (the Stage values of
# csrc/warp_u8_offsets.cu).
B1_STAGES = ((0, 0, "general_full"), (0, 1, "general_no_taps"),
             (0, 2, "general_identity_coordinate"),
             (0, 4, "general_index32_3d_launch"), (0, 8, "general_no_stores"),
             (1, 1, "packed_no_taps"), (1, 2, "packed_identity_coordinate"),
             (1, 3, "packed_no_taps_identity_coordinate"))


def launch_b1_stage(frames, rows, out, crop, packed: int, stage: int
                    ) -> None:
    fn = _build.library("warp_u8_offsets").dvsg_warp_u8_offsets_probe
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, h, w, c = frames.shape
    rc = fn(frames.data_ptr(), rows.data_ptr(), out.data_ptr(), b, h, w, c,
            rows.shape[2], float(crop), stage, packed,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"offsets kernel stage {stage} (packed "
                           f"{packed}): CUDA error {rc}")


def time_b1(frames, offsets, crop) -> dict:
    b, h, w, c = frames.shape
    gh, gw = offsets.shape[1:3]
    # ms is the wrapper's time: the offsets' row upsample (one einsum) and
    # the kernel. kernel_ms is the kernel's launch alone, on those rows.
    ms = median_ms(lambda: warp_wide.warp_u8_offsets(frames, offsets, crop))
    rows = warp_wide.offset_rows(offsets, h)
    out = torch.empty_like(frames)
    # The two kernels and their stage variants, in turns.
    turns = [("general", lambda: warp_wide._launch(frames, rows, crop,
                                                   packed=False)),
             ("packed", lambda: warp_wide._launch(frames, rows, crop,
                                                  packed=True))]
    turns += [(name, lambda p=p, k=k: launch_b1_stage(
        frames, rows, out, crop, p, k)) for p, k, name in B1_STAGES]
    in_turns = time_in_turns(turns)
    kernel_ms = float(np.mean(in_turns["packed"]))
    general_ms = float(np.mean(in_turns["general"]))
    plain_ms = median_ms(lambda: warp_wide.warp_u8_offsets_plain(
        frames, offsets, crop), iters=10)
    # Yardstick: one grid_sample call computing the same warp on f32 NCHW
    # frames from the dense grid (both made outside the timed call).
    src = frames.permute(0, 3, 1, 2).to(torch.float32).contiguous()
    grids = grid_ops.grid_from_offsets(offsets, h, w, crop)
    lib_ms = median_ms(lambda: F.grid_sample(
        src, grids, mode="bilinear", padding_mode="border",
        align_corners=True))
    # Bound: frames read once and written once, offsets read once; ~60 f32
    # operations per output pixel (coordinates, 4 taps x C lerps, rounds).
    bound_ms, by = bound(2 * b * h * w * c + offsets.numel() * 4,
                         b * h * w * (30 + 10 * c))
    rec = {"ms": ms, "kernel_ms": kernel_ms, "general_kernel_ms": general_ms,
           "in_turns_ms": in_turns, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": by,
           "frames_per_call": b, "shape": [b, h, w, c], "grid": [gh, gw]}
    log(f"  warp_u8_offsets {b}x{h}x{w}x{c}, medians of 20 from a cold L2: "
        f"wrapper {ms:.4f} ms = {1e3 * ms / b:.3f} us/frame; packed kernel "
        f"alone {kernel_ms:.4f} ms = {100 * bound_ms / kernel_ms:.1f} % of "
        f"the bound {bound_ms:.5f} ms ({by}); general-shape kernel "
        f"{general_ms:.4f} ms; plain {plain_ms:.4f} ms; F.grid_sample "
        f"{lib_ms:.4f} ms")
    log("  in turns, ms: " + "; ".join(
        f"{k} {' / '.join(f'{v:.4f}' for v in vs)}"
        for k, vs in in_turns.items()))
    if not kernel_ms < general_ms:
        raise AssertionError("the packed kernel is no faster than the "
                             "general-shape one on the main path's shape")
    return rec


# --- path smoothing, auto-crop, online and overlap ---------------------------

def make_sway_clip(seed: int, n: int, h: int, w: int, dev):
    """Seeded sway clip with the port's synthetic renderer: x/y sway with
    periods 40 and 56 frames plus per-frame jitter. Returns (uint8 frames,
    the still on ``dev``, the (n, 5) path)."""
    t = np.arange(n)
    rng = np.random.default_rng(seed + 3)
    path5 = np.zeros((n, 5), np.float32)
    path5[:, 0] = 0.05 * np.sin(2 * np.pi * t / 40) \
        + rng.normal(0, 0.008, n)
    path5[:, 1] = 0.04 * np.sin(2 * np.pi * t / 56 + 1.0) \
        + rng.normal(0, 0.008, n)
    still = synthetic.random_still(torch.Generator().manual_seed(seed + 11),
                                   h, w, device=dev)
    return render_poses(still, path5), still, path5


def render_poses(still: torch.Tensor, path5: np.ndarray) -> np.ndarray:
    frames = synthetic.jitter_frames(still, torch.from_numpy(path5).to(
        still.device))
    return synthetic.to_u8(frames).cpu().numpy()


def ideal_corrections(path5: np.ndarray, window: int, horizon: int,
                      clamp: float, lag: int) -> np.ndarray:
    """The smoother's output pose (x, y) per frame computed in float64 from
    the true path: the window mean plus the correction of the same
    recursion (causal EMA with anti-windup, or the lag FIR on its taps),
    replicate-padded at both ends as the pipeline pads."""
    p = path5[:, :2].astype(np.float64)
    n_fr = len(p)
    pp = np.concatenate([np.repeat(p[:1], window - 1, 0), p])
    delta = np.zeros((n_fr + lag + 1, 2))
    delta[1:n_fr] = np.diff(p, axis=0)     # delta[j] = p_j - p_(j-1)
    k_past, taps = pathsmooth._lag_taps_np(horizon, lag, window) \
        if lag else (0, None)
    alpha = 2.0 / (horizon + 1.0)
    d = np.zeros(2)
    out = []
    for g in range(n_fr):
        gi = g + window - 1
        abar = pp[gi - window + 1:gi + 1].mean(0)
        rel = pp[gi] - abar
        if lag:
            fir = sum(taps[m] * delta[g + m - k_past + 1]
                      for m in range(len(taps))
                      if 0 <= g + m - k_past + 1 < len(delta))
            e = np.clip(rel + fir, -clamp, clamp)
        else:
            d = (1 - alpha) * (d + (pp[gi] - pp[gi - 1]))
            e = np.clip(rel - d, -clamp, clamp)
            d = rel - e
        out.append(abar + e)
    return np.array(out)


def tracked_rms(frames: np.ndarray, mh: int, mw: int, dev) -> float:
    """RMS about its mean of the cumulative translation that
    ``pathsmooth.measure_shifts`` finds in ``frames`` at model
    resolution: the residual camera path of a stabilized clip."""
    with torch.inference_mode():
        seq = resize_ops.downscale_norm(stab_lib.put_frames(frames, dev),
                                        mh, mw)
        d, _ = pathsmooth.measure_shifts(seq)
    p = np.cumsum(d.cpu().numpy().astype(np.float64), axis=0)
    return float(np.sqrt(((p - p.mean(0)) ** 2).mean()))


class FailingWriter(MemWriter):
    """MemWriter whose ``fail_at``-th write raises (a killed job)."""

    def __init__(self, total: int, shape, fail_at: int):
        super().__init__(total, shape)
        self.fail_at, self.calls = fail_at, 0

    def write_batch(self, frames: np.ndarray) -> None:
        if self.calls == self.fail_at:
            raise RuntimeError("injected encoder failure")
        self.calls += 1
        super().write_batch(frames)


def interrupted_then_resumed(stab, clip: np.ndarray, fail_at: int):
    """A stream with a resume record killed at its ``fail_at``-th write,
    then resumed on the same input: (frames, written and lag_real of the
    record it resumed from)."""
    with tempfile.TemporaryDirectory() as resume_dir:
        first = FailingWriter(len(clip), clip.shape[1:], fail_at)
        try:
            stab.stabilize_stream(MemReader(clip), first,
                                  resume_dir=resume_dir)
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
        else:
            raise AssertionError("the failing writer never failed")
        with np.load(os.path.join(resume_dir, "resume_state.npz")) as z:
            written = int(z["frames_written"])
            lag_real = int(z["lag_real"]) if "lag_real" in z else None
        second = MemWriter(len(clip), clip.shape[1:])
        second.frames[:written] = first.frames[:written]
        n = stab.stabilize_stream(MemReader(clip), second,
                                  resume_dir=resume_dir)
    if n != len(clip):
        raise AssertionError(f"resumed stream wrote {n} of {len(clip)}")
    return second.frames, written, lag_real


def stream_run(stab, clip: np.ndarray, overlapped: bool):
    """(frames, seconds, StageTimer totals) of one stream of ``clip``."""
    writer = MemWriter(len(clip), clip.shape[1:])
    timer = StageTimer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if overlapped:
        n = stabilize_stream_overlapped(stab, MemReader(clip), writer,
                                        timer=timer)
    else:
        n = stab.stabilize_stream(MemReader(clip), writer, timer=timer)
    wall = time.perf_counter() - t0
    if n != len(clip):
        raise AssertionError(f"stream wrote {n} of {len(clip)} frames")
    return writer.frames, wall, {k: v["total_s"]
                                 for k, v in timer.summary().items()}


def b2b_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median ms of ``iters`` calls back to back, each between its own
    CUDA events: a stage bound by the host's launches reads as the time
    the host takes to issue it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def queued_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device ms of ``iters`` calls, each queued behind its own
    ~10 ms matrix product, so the host has issued the whole call before
    the card reaches it: the device's time alone."""
    stall, _ = _stall_and_flush(torch.device("cuda", 0))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        stall()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


@torch.inference_mode()
def smooth_stage_times(stab, lag_stab, clip: np.ndarray, dev) -> dict:
    """Per-chunk times of the smoothing stages and of the plain, smoothed
    and lag chunk steps on the sway clip's first chunk: back to back (what
    the chunk loop sees) and queued (the device's time)."""
    cfg, lag_cfg, model = stab.cfg, lag_stab.cfg, stab.model
    frames = stab_lib.put_frames(clip[:T_CHUNK], dev)
    halo = stab._initial_halo(clip[0])
    mh, mw = cfg.model.model_size
    seq = torch.cat([halo, resize_ops.downscale_norm(frames, mh, mw)])
    offsets = stab_lib.predict_chunk_offsets(cfg, model, seq, T_CHUNK)
    state = pathsmooth.initial_state(dev)
    deltas, conf = pathsmooth.measure(cfg, seq)
    e, _ = pathsmooth.corrections_from_measured(cfg, deltas, conf, T_CHUNK,
                                                state)
    smooth_step = stab_lib.ChunkStep(cfg, model)
    lag_step = stab_lib.ChunkStep(lag_cfg, model)
    carry = lag_step.fresh_carry(frames)
    d_ext = torch.cat([carry[2], deltas])
    c_ext = torch.cat([carry[3], conf])
    stages = {
        "measure": lambda: pathsmooth.measure(cfg, seq),
        "ema_scan": lambda: pathsmooth.corrections_from_measured(
            cfg, deltas, conf, T_CHUNK, state),
        "lag_fir": lambda: pathsmooth.lag_corrections(lag_cfg, d_ext, c_ext,
                                                      T_CHUNK),
        "apply": lambda: pathsmooth.apply_corrections(cfg, offsets, e),
        "plain_chunk": lambda: stab_lib.stabilize_chunk_impl(
            cfg, model, frames, halo),
        "smoothed_chunk": lambda: smooth_step(frames, halo),
        "lag_chunk": lambda: lag_step(frames, halo),
    }
    return {name: {"b2b_ms": b2b_ms(fn), "queued_ms": queued_ms(fn)}
            for name, fn in stages.items()}


@torch.inference_mode()
def no_host_sync(stab, lag_stab, clip: np.ndarray, dev) -> None:
    """One call of each smoothed chunk step (after a warm-up call that
    builds the cached tables) under ``set_sync_debug_mode("error")``: any
    host synchronization inside raises."""
    frames = stab_lib.put_frames(clip[:T_CHUNK], dev)
    halo = stab._initial_halo(clip[0])
    steps = (stab_lib.ChunkStep(stab.cfg, stab.model),
             stab_lib.ChunkStep(lag_stab.cfg, lag_stab.model))
    for step in steps:
        step(frames, halo)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(frames, halo)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


def lsb(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def phase_smoothing(seed: int, dev):
    """Path smoothing (causal and lag), auto-crop, online and overlap for
    both presets on the sway clip. Returns (offsets-kernel launches in the
    smoothed clip runs, per-preset results)."""
    clip, still, path5 = make_sway_clip(seed, SWAY_FRAMES, HEIGHT, WIDTH,
                                        dev)
    small, _, _ = make_sway_clip(seed + 1, *SMALL_SWAY, dev)
    chunks = {"causal": math.ceil(SWAY_FRAMES / T_CHUNK),
              "lag": math.ceil((SWAY_FRAMES + LAG) / T_CHUNK)}
    launches = 0
    results = {}
    for preset, ckpt in PRESETS:
        params, mcfg = load_npz(os.path.join(ROOT, "checkpoints", ckpt))
        mh, mw = mcfg.model_size
        plain_cfg = StabilizeConfig(model=mcfg, chunk_frames=T_CHUNK)
        cfgs = {"causal": plain_cfg.replace(path_smooth=SMOOTH),
                "lag": plain_cfg.replace(path_smooth=SMOOTH,
                                         path_smooth_lag=LAG)}
        stabs = {m: stab_lib.Stabilizer(c, params, device="cuda")
                 for m, c in cfgs.items()}
        plain = stab_lib.Stabilizer(plain_cfg, params, device="cuda")
        res = {}
        outs = {"plain": plain.stabilize_clip(clip)}
        for mode, stab in stabs.items():
            warp_wide.LAUNCHES = warp_wide.LAUNCHES_PACKED = 0
            out = stab.stabilize_clip(clip)
            torch.cuda.synchronize()
            n, n_packed = warp_wide.LAUNCHES, warp_wide.LAUNCHES_PACKED
            launches += n
            outs[mode] = out
            if out.shape != clip.shape or out.dtype != np.uint8:
                raise AssertionError(f"[{preset} {mode}] output {out.shape}")
            if n != chunks[mode] or n_packed != chunks[mode]:
                raise AssertionError(
                    f"[{preset} {mode}] {n} launches, {n_packed} packed, "
                    f"for {chunks[mode]} chunks")
            stream, _, _ = stream_run(stab, clip, overlapped=False)
            if not np.array_equal(stream, out):
                raise AssertionError(f"[{preset} {mode}] stream != clip")
            resumed, at, _ = interrupted_then_resumed(stab, clip, 2)
            if not np.array_equal(resumed, out):
                raise AssertionError(f"[{preset} {mode}] stream resumed at "
                                     f"frame {at} differs")
            rec = {"launches": n, "packed": n_packed,
                   "chunks": chunks[mode], "resumed_at": at}
            if mode == "lag":
                # 88 frames: the record after the fifth write is written
                # after the end was found, with 8 of the 16 carried frames
                # real (the drain region).
                short = clip[:88]
                drained, at, real = interrupted_then_resumed(stab, short, 5)
                if real is None or not 0 < real < LAG:
                    raise AssertionError(f"[{preset}] the record at {at} "
                                         f"has lag_real {real}")
                if not np.array_equal(drained, stab.stabilize_clip(short)):
                    raise AssertionError(f"[{preset}] stream resumed in the "
                                         f"drain region differs")
                rec.update(drain_resumed_at=at, drain_lag_real=real)
            cpu = stab_lib.Stabilizer(cfgs[mode], params, device="cpu")
            rec["card_vs_cpu_max_lsb"] = lsb(cpu.stabilize_clip(small),
                                             stab.stabilize_clip(small))
            if rec["card_vs_cpu_max_lsb"] > 1:
                raise AssertionError(f"[{preset} {mode}] card vs CPU: "
                                     f"{rec['card_vs_cpu_max_lsb']} LSB")
            res[mode] = rec

        # Quality: the residual translation path and PSNR against the
        # ideal target, each smoothed mode against the unsmoothed output.
        rms = {m: tracked_rms(o, mh, mw, dev) for m, o in outs.items()}
        bh, bw = int(HEIGHT * 0.15), int(WIDTH * 0.15)
        inner = (slice(None), slice(bh, HEIGHT - bh), slice(bw, WIDTH - bw))
        for mode in cfgs:
            th = np.zeros_like(path5)
            th[:, :2] = ideal_corrections(path5, mcfg.window, SMOOTH,
                                          cfgs[mode].path_smooth_max,
                                          cfgs[mode].path_smooth_lag)
            target = render_poses(still, th)
            p_s = psnr(outs[mode][inner], target[inner])
            p_p = psnr(outs["plain"][inner], target[inner])
            res[mode].update(rms_smoothed=rms[mode], rms_plain=rms["plain"],
                             psnr_ideal_smoothed_db=p_s,
                             psnr_ideal_plain_db=p_p)
            log(f"  [{preset} {mode}] {res[mode]['launches']} launches for "
                f"{chunks[mode]} chunks (all packed); stream == clip; "
                f"resumed at {res[mode]['resumed_at']} == uninterrupted"
                + (f"; resumed in the drain region at "
                   f"{res[mode]['drain_resumed_at']} (lag_real "
                   f"{res[mode]['drain_lag_real']}) == uninterrupted"
                   if mode == "lag" else "")
                + f"; card vs CPU {res[mode]['card_vs_cpu_max_lsb']} LSB; "
                f"residual path RMS {rms[mode]:.5f} vs unsmoothed "
                f"{rms['plain']:.5f} ({rms[mode] / rms['plain']:.3f}x); "
                f"PSNR vs ideal {p_s:.3f} dB vs unsmoothed {p_p:.3f} dB")
            if not rms[mode] < 0.75 * rms["plain"]:
                raise AssertionError(f"[{preset} {mode}] residual path RMS "
                                     f"{rms[mode]:.5f} vs {rms['plain']:.5f}")
            if not p_s > p_p:
                raise AssertionError(f"[{preset} {mode}] PSNR vs ideal "
                                     f"{p_s:.3f} <= unsmoothed {p_p:.3f}")

        # Auto-crop: every applied coordinate of the picked crop in frame.
        causal = stabs["causal"]
        crop, m, capped = autocrop.pick_border_crop(cfgs["causal"], params,
                                                    clip, device="cuda")
        cropped = stab_lib.Stabilizer(cfgs["causal"].replace(
            border_crop=crop), params, device="cuda")
        cropped.begin_stream()
        halo = cropped._initial_halo(clip[0])
        worst = 0.0
        for start in range(0, SWAY_FRAMES, T_CHUNK):
            _, halo, offs = cropped._chunk(stab_lib.put_frames(
                clip[start:start + T_CHUNK], dev), halo)
            g = grid_ops.grid_from_offsets(offs, HEIGHT, WIDTH, crop)
            worst = max(worst, float(g.abs().max()))
        log(f"  [{preset}] pick_border_crop: max |offset| {m:.5f} -> crop "
            f"{crop:.5f} (capped {capped}); largest |coordinate| applied "
            f"{worst:.7f}")
        if capped or worst > 1.0 + 1e-5:
            raise AssertionError(f"[{preset}] crop {crop} leaves coordinate "
                                 f"{worst}")

        # Online push == clip; overlapped == sync.
        online = OnlineStabilizer(cfgs["causal"], params, device="cuda")
        pushed = [f for frame in clip for f in online.push(frame)]
        pushed += online.flush()
        if not np.array_equal(np.stack(pushed), outs["causal"]):
            raise AssertionError(f"[{preset}] online push != clip")
        streams = {}
        for name, stab in (("plain", plain), ("causal", causal)):
            for depth in (1, 3):
                stab.cfg = stab.cfg.replace(queue_depth=depth)
                got, _, _ = stream_run(stab, clip, overlapped=True)
                if not np.array_equal(got, outs[name]):
                    raise AssertionError(f"[{preset} {name}] overlapped "
                                         f"(depth {depth}) != sync")
            runs = {"sync": [], "overlapped": []}
            for overlapped in (False, True, True, False):
                _, wall, stages = stream_run(stab, clip, overlapped)
                runs["overlapped" if overlapped else "sync"].append(
                    {"s": wall, "fps": SWAY_FRAMES / wall,
                     "stage_s": stages})
            streams[name] = runs
            log(f"  [{preset} {name}] overlapped == sync (depths 1, 3); "
                + "; ".join(
                    f"{k} " + " / ".join(f"{r['fps']:.1f}" for r in v)
                    + " frames/s (" + ", ".join(
                        f"{s} {1e3 * t:.2f} ms"
                        for s, t in v[0]["stage_s"].items()) + ")"
                    for k, v in runs.items()))

        no_host_sync(causal, stabs["lag"], clip, dev)
        times = smooth_stage_times(causal, stabs["lag"], clip, dev)
        log(f"  [{preset}] no host sync in the smoothed and lag chunk steps;"
            f" per chunk (T={T_CHUNK}), ms back to back / queued: "
            + ", ".join(f"{k} {v['b2b_ms']:.4f} / {v['queued_ms']:.4f}"
                        for k, v in times.items()))
        dev_fps = {k: 1e3 * T_CHUNK / times[f"{k}_chunk"]["b2b_ms"]
                   for k in ("plain", "smoothed", "lag")}
        log(f"  [{preset}] device frames/s back to back: " + ", ".join(
            f"{k} {v:.1f}" for k, v in dev_fps.items()))
        results[preset] = {"modes": res, "crop": crop, "crop_max_offset": m,
                           "crop_worst_coordinate": worst,
                           "streams": streams, "stage_ms": times,
                           "device_fps": dev_fps}
    return launches, results


# --- the training path -------------------------------------------------------

def reset_train_launches() -> None:
    warp_bilinear.LAUNCHES_WARP = 0
    warp_bilinear.LAUNCHES_DIFF_FWD = 0
    warp_bilinear.LAUNCHES_DIFF_BWD = 0


def train_launches() -> dict:
    return {"warp_f32": warp_bilinear.LAUNCHES_WARP,
            "warp_f32_diff_fwd": warp_bilinear.LAUNCHES_DIFF_FWD,
            "warp_f32_diff_bwd": warp_bilinear.LAUNCHES_DIFF_BWD}


def gelu_launches() -> dict:
    return {"gelu_bf16_fwd": bf16_round.LAUNCHES_GELU_FWD,
            "gelu_bf16_bwd": bf16_round.LAUNCHES_GELU_BWD}


def gn_launches() -> dict:
    return {"group_norm_bf16_fwd": bf16_round.LAUNCHES_GN_FWD,
            "group_norm_bf16_bwd": bf16_round.LAUNCHES_GN_BWD}


def gn_calls(mcfg) -> int:
    """The bf16 conv + GroupNorm calls of one pass of the trunk: two a
    ResBlock."""
    return 2 * motion_cnn.pyramid_levels(mcfg) * mcfg.blocks_per_level


def gelu_calls(mcfg) -> int:
    """The bf16 GELU calls of one pass of the corr model's encoder: the
    stem's, then each level's down conv's and two a ResBlock."""
    return 1 + motion_cnn.pyramid_levels(mcfg) * (
        1 + 2 * mcfg.blocks_per_level)


@contextlib.contextmanager
def plain_warps():
    """Route the training path's two warps and the bf16 GELU's and
    GroupNorm's kernels to their plain versions (on whatever device), to
    hold the kernels' step against."""
    saved = (warp_ops.warp_batch, warp_ops.warp_batch_diff,
             bf16_round._launch_fwd, bf16_round._launch_bwd,
             bf16_round._launch_gn_fwd, bf16_round._launch_gn_bwd)
    warp_ops.warp_batch = warp_bilinear.bilinear_warp_batch_plain
    warp_ops.warp_batch_diff = \
        warp_bilinear.bilinear_warp_batch_grids_diff_plain
    bf16_round._launch_fwd = bf16_round.gelu_plain
    bf16_round._launch_bwd = bf16_round.gelu_grad_plain
    bf16_round._launch_gn_fwd = bf16_round.group_norm_bf16_plain
    bf16_round._launch_gn_bwd = bf16_round.group_norm_bf16_grad_plain
    try:
        yield
    finally:
        (warp_ops.warp_batch, warp_ops.warp_batch_diff,
         bf16_round._launch_fwd, bf16_round._launch_bwd,
         bf16_round._launch_gn_fwd, bf16_round._launch_gn_bwd) = saved


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


def kernels_vs_plain_step(state, cfg, step: int, loss_tol: float = 1e-4,
                          grad_tol: float = 1e-3) -> dict:
    """One step's loss and parameter gradients through the kernels against
    the same step through the plain versions, both on the card. A bf16
    step launches each GELU kernel once a GELU call and each GroupNorm
    kernel once a conv + GroupNorm call, an f32 step neither."""
    def launches():
        return {**train_launches(), **gelu_launches(), **gn_launches()}
    reset = launches()
    aux_k, grads_k = loss_and_grads(state, cfg, step)
    used = {k: v - reset[k] for k, v in launches().items()}
    with plain_warps():
        before = launches()
        aux_p, grads_p = loss_and_grads(state, cfg, step)
        if launches() != before:
            raise AssertionError("the plain step launched a kernel")
    bf16 = cfg.model.dtype == "bfloat16"
    n_gelu, n_gn = (gelu_calls(cfg.model), gn_calls(cfg.model)) if bf16 \
        else (0, 0)
    if (min(used[k] for k in train_launches()) < 1
            or any(used[k] != n_gelu for k in gelu_launches())
            or any(used[k] != n_gn for k in gn_launches())):
        raise AssertionError(f"the kernel step launched {used}")
    loss_rel = abs(aux_k["total"] - aux_p["total"]) / abs(aux_p["total"])
    grad_rel = max(
        float((grads_k[n] - g).abs().max()) / max(float(g.abs().max()),
                                                  1e-30)
        for n, g in grads_p.items())
    # The f32 kernels sit a few ulp from the plain warp; cuDNN's backward
    # sums in an order that varies from run to run.
    if loss_rel > loss_tol or grad_rel > grad_tol:
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


def expect_gelu_launches(name: str, mcfg, steps: int) -> dict:
    """The bf16 GELU kernels' launches since their counters were set to 0:
    one forward and one backward a GELU call of each train step."""
    got, want = gelu_launches(), gelu_calls(mcfg) * steps
    log(f"  [{name}] GELU kernel launches in {steps} steps: {got} "
        f"(want {want} each)")
    if any(v != want for v in got.values()):
        raise AssertionError(f"[{name}] GELU launches {got} for {steps} "
                             f"steps of {gelu_calls(mcfg)} calls")
    return got


def expect_gn_launches(name: str, mcfg, steps: int) -> dict:
    """The bf16 GroupNorm kernels' launches since their counters were set
    to 0: one forward and one backward a conv + GroupNorm call (two a
    ResBlock) of each train step."""
    got, want = gn_launches(), gn_calls(mcfg) * steps
    log(f"  [{name}] GroupNorm kernel launches in {steps} steps: {got} "
        f"(want {want} each)")
    if any(v != want for v in got.values()):
        raise AssertionError(f"[{name}] GroupNorm launches {got} for "
                             f"{steps} steps of {gn_calls(mcfg)} calls")
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


# Stage variants of the two dense-grid uint8 kernels, (packed, stage,
# name): what each leaves out of its kernel (the Stage values of
# csrc/warp_u8_batch.cu).
B4_STAGES = ((0, 4, "general_index32_3d_launch"), (1, 1, "packed_no_taps"),
             (1, 2, "packed_no_grid"), (1, 3, "packed_no_taps_no_grid"),
             (1, 8, "packed_no_stores"))


def launch_b4_stage(frames, grids, out, packed: int, stage: int) -> None:
    fn = _build.library("warp_u8_batch").dvsg_warp_u8_batch_probe
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, h, w, c = frames.shape
    rc = fn(frames.data_ptr(), grids.data_ptr(), out.data_ptr(), b, h, w, c,
            grids.shape[1], grids.shape[2], stage, packed,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dense-grid kernel stage {stage} (packed "
                           f"{packed}): CUDA error {rc}")


def time_b4(frames, grids, bound_ms: float) -> dict:
    """The two dense-grid uint8 kernels and their stage variants, in turns,
    each beside the length of its SASS."""
    b, _, _, c = frames.shape
    out = torch.empty((b, grids.shape[1], grids.shape[2], c),
                      dtype=torch.uint8, device=frames.device)
    turns = [("general", lambda: warp_wide._launch_batch(frames, grids,
                                                         packed=False)),
             ("packed", lambda: warp_wide._launch_batch(frames, grids,
                                                        packed=True))]
    turns += [(name, lambda p=p, k=k: launch_b4_stage(
        frames, grids, out, p, k)) for p, k, name in B4_STAGES]
    in_turns = time_in_turns(turns)
    counts = sass_counts("warp_u8_batch")

    def sass(packed: int, stage: int):
        kernel = ("warp_u8_batch_packed_kernel" if packed
                  else "warp_u8_batch_kernel")
        tag = f"{len(kernel)}{kernel}ILi{stage}E"
        return next((n for k, n in counts.items() if tag in k), None)

    sass_of = {"general": sass(0, 0), "packed": sass(1, 0),
               **{name: sass(p, k) for p, k, name in B4_STAGES}}
    kernel_ms = float(np.mean(in_turns["packed"]))
    general_ms = float(np.mean(in_turns["general"]))
    log(f"  warp_u8_batch kernels in turns, medians of 20 from a cold L2: "
        f"packed {kernel_ms:.4f} ms = {100 * bound_ms / kernel_ms:.1f} % of "
        f"the bound {bound_ms:.5f} ms; general-shape {general_ms:.4f} ms")
    log("  in turns, ms (SASS instructions): " + "; ".join(
        f"{k} {' / '.join(f'{v:.4f}' for v in vs)} ({sass_of[k]})"
        for k, vs in in_turns.items()))
    if not kernel_ms < general_ms:
        raise AssertionError("the packed dense-grid kernel is no faster "
                             "than the general-shape one on the 720p chunk")
    return {"kernel_ms": kernel_ms, "general_kernel_ms": general_ms,
            "in_turns_ms": in_turns, "sass": sass_of}


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

    # The loss warp, B = 16: forward (values only) and backward (cotangent,
    # frames and grid in, grid cotangent out).
    b = 16
    frames, grids, nchw = frames[:b].contiguous(), grids[:b].contiguous(), \
        nchw[:b].contiguous()
    grids16 = grids
    n_pix = b * h * w
    cot = torch.from_numpy(rng.standard_normal(
        (b, h, w, c)).astype(np.float32)).to(dev)
    bound_ms, by = bound(4 * (frames.numel() + grids.numel() + n_pix * c),
                         n_pix * (20 + 6 * c))
    recs["warp_f32_diff_fwd"] = {
        "ms": median_ms(lambda: warp_bilinear.warp_diff_forward(
            frames, grids)),
        "plain_ms": median_ms(
            lambda: warp_bilinear.bilinear_warp_batch_plain(frames, grids)),
        "library_ms": median_ms(lambda: lib(nchw, grids)),
        # The same warp through warp_f32's kernel (strided stores), beside
        # the forward's RGB kernel (stores staged in shared memory).
        "general_kernel_ms": median_ms(
            lambda: warp_bilinear.bilinear_warp_batch(frames, grids)),
        "bound_ms": bound_ms, "bound_by": by, "shape": [b, h, w, c]}
    g_req = grids.clone().requires_grad_()
    lib_out = lib(nchw, g_req)
    cot_nchw = cot.permute(0, 3, 1, 2).contiguous()
    bound_ms, by = bound(4 * (n_pix * c + frames.numel()
                              + 2 * grids.numel()), n_pix * (30 + 14 * c))
    recs["warp_f32_diff_bwd"] = {
        "ms": median_ms(lambda: warp_bilinear.warp_diff_backward(
            cot, frames, grids)),
        "plain_ms": median_ms(
            lambda: warp_bilinear.warp_diff_grid_grad_plain(
                cot, frames, grids)),
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
    recs["warp_u8_batch"].update(time_b4(frames8, grids, bound_ms))
    warm = {
        "warp_f32": lambda: warp_bilinear.bilinear_warp_batch(
            frames64, grids64),
        "warp_f32_diff_fwd": lambda: warp_bilinear.warp_diff_forward(
            frames, grids16),
        "warp_f32_diff_bwd": lambda: warp_bilinear.warp_diff_backward(
            cot, frames, grids16),
        "warp_u8_batch": lambda: warp_wide.warp_u8_batch(frames8, grids),
    }
    for name, fn in warm.items():
        recs[name]["warm_l2_ms"] = median_ms(fn, cold=False)
    for name, r in recs.items():
        log(f"  {name} {r['shape']}: {r['ms']:.4f} ms from a cold L2 "
            f"({r['warm_l2_ms']:.4f} ms back to back); bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); plain "
            f"{r['plain_ms']:.4f} ms; F.grid_sample "
            f"{r['library_ms']:.4f} ms"
            + (f"; warp_f32's kernel on the same inputs "
               f"{r['general_kernel_ms']:.4f} ms"
               if name == "warp_f32_diff_fwd" else ""))
    return recs


# The bf16 GELU's largest call on its path: the quality stem's output for
# the training step's 192 frames (32 clips of 6), 32 x 256 x 256 each.
GELU_SHAPE = (192, 32, 256, 256)


def gelu_values_differ(got: torch.Tensor, want: torch.Tensor) -> int:
    """The values of ``got`` whose bytes differ from ``want``'s; raises
    where the two differ in dtype, shape or layout."""
    if (got.dtype, got.shape, got.stride()) != (want.dtype, want.shape,
                                                want.stride()):
        raise AssertionError(f"kernel output {got.dtype} {got.stride()}, "
                             f"op chain's {want.dtype} {want.stride()}")
    view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return int((got.view(view) != want.view(view)).sum())


def time_gelu_kernels(dev) -> dict:
    """Both bf16 GELU kernels at ``GELU_SHAPE``, beside their bound (4 and
    6 bytes an element), the plain op chain and one PyTorch call of the
    same function (``F.gelu``'s tanh form, and its backward op), which
    rounds once and is timed as a yardstick only. Before the times, each
    kernel's bytes against the chain's at that shape: the forward with a
    bf16 and an f32 output, the backward with a bf16 and an f32 cotangent
    and with a channels-last one, as the training backward gives the
    deepest level's GELUs. Raises on a value that differs."""
    x = (torch.randn(GELU_SHAPE, device=dev) * 2.0).bfloat16()
    g = torch.randn(GELU_SHAPE, device=dev).bfloat16()
    n = x.numel()
    recs = {}
    for name, cases in (
            ("gelu_bf16_fwd", (
                ("bf16 out", lambda: bf16_round.gelu_bf16(x, False),
                 lambda: bf16_round.gelu_plain(x, False)),
                ("f32 out", lambda: bf16_round.gelu_bf16(x, True),
                 lambda: bf16_round.gelu_plain(x, True)))),
            ("gelu_bf16_bwd", (
                ("bf16 g", lambda: bf16_round.gelu_bf16_bwd(x, g),
                 lambda: bf16_round.gelu_grad_plain(x, g)),
                ("f32 g", lambda: bf16_round.gelu_bf16_bwd(x, g.float()),
                 lambda: bf16_round.gelu_grad_plain(x, g.float())),
                ("channels-last g", lambda: bf16_round.gelu_bf16_bwd(
                    x, g.contiguous(memory_format=torch.channels_last)),
                 lambda: bf16_round.gelu_grad_plain(
                     x, g.contiguous(memory_format=torch.channels_last)))))):
        differ = 0
        for case, kernel, plain in cases:
            d = gelu_values_differ(kernel(), plain())
            log(f"  {name} {list(GELU_SHAPE)}, {case}: {d} values differ "
                f"from the op chain")
            differ += d
        if differ:
            raise AssertionError(f"{name} differs from the op chain at "
                                 f"{list(GELU_SHAPE)} on {differ} values")
        recs[name] = {"values_differ": differ}
    for name, n_bytes, kernel, plain, library in (
            ("gelu_bf16_fwd", 4 * n,
             lambda: bf16_round.gelu_bf16(x, False),
             lambda: bf16_round.gelu_plain(x, False),
             lambda: F.gelu(x, approximate="tanh")),
            ("gelu_bf16_bwd", 6 * n,
             lambda: bf16_round.gelu_bf16_bwd(x, g),
             lambda: bf16_round.gelu_grad_plain(x, g),
             lambda: torch.ops.aten.gelu_backward(g, x,
                                                  approximate="tanh"))):
        bound_ms, by = bound(n_bytes, 0)
        recs[name].update({"ms": median_ms(kernel), "warm_l2_ms": median_ms(
            kernel, cold=False), "plain_ms": median_ms(plain, iters=10),
            "library_ms": median_ms(library), "bound_ms": bound_ms,
            "bound_by": by, "shape": list(GELU_SHAPE)})
        r = recs[name]
        log(f"  {name} {r['shape']} bf16: {r['ms']:.4f} ms from a cold L2 "
            f"({r['warm_l2_ms']:.4f} ms back to back) = "
            f"{100 * bound_ms / r['ms']:.1f} % of the bound {bound_ms:.4f} "
            f"ms ({by}); plain op chain {r['plain_ms']:.4f} ms; one PyTorch "
            f"call (tanh GELU, one rounding) {r['library_ms']:.4f} ms")
    return recs


# The bf16 GroupNorm's largest call on its path: the quality trunk's first
# level for the training step's 192 frames, 64 x 128 x 128 each, 8 groups.
GN_SHAPE, GN_GROUPS = (192, 64, 128, 128), 8


def bf16_steps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """The bf16 steps between two bf16 tensors, value by value (their
    ordered bit patterns; ±0 are one)."""
    def order(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (order(got) - order(want)).abs()


def gn_ulps_at_scale(got, want, x, bias, weight, beta, stats, groups: int,
                     eps: float) -> float:
    """The most bf16 ulps between two bf16 GroupNorm outputs at the scale
    of the normalize's largest term (the output, (y - mean) * s or the
    shift): where the shift cancels the product, an f32 ulp of the
    statistics is many bf16 steps of the output."""
    c = x.shape[1]
    mean = stats[..., 0].repeat_interleave(c // groups, dim=1)
    s = (stats[..., 1].clamp(min=0) + eps).rsqrt().repeat_interleave(
        c // groups, dim=1) * weight
    y = x.float() + bias.bfloat16().float()[:, None, None]
    scale = torch.maximum(
        torch.maximum(got.float().abs(), want.float().abs()),
        torch.maximum(((y - mean[..., None, None]) * s[..., None, None]
                       ).abs(), beta.abs()[:, None, None].expand_as(y)))
    ulp = torch.exp2(torch.floor(torch.log2(scale.clamp(min=2.0 ** -126)))
                     - 7)
    return float(((got.float() - want.float()).abs() / ulp).max())


def gn_chain64(x, bias, weight, beta, g, groups: int, eps: float) -> tuple:
    """The bf16 GroupNorm chain's formulas with every f32 op and sum in
    float64 and every bf16 rounding kept: (output, (B, groups, 2) mean and
    variance, dx, dbias, dweight, dbeta)."""
    b, c, h, w = x.shape
    cpg = c // groups
    y = x.double() + bias.bfloat16().double()[:, None, None]
    q = y.bfloat16().double().reshape(b, groups, -1)
    n = q.shape[-1]
    mean = q.mean(dim=-1, keepdim=True)
    var = ((q - mean) ** 2).mean(dim=-1, keepdim=True)
    del q
    r5 = (var + eps).rsqrt().reshape(b, groups, 1, 1, 1)
    s = r5 * weight.double().reshape(groups, cpg, 1, 1)
    d = y.reshape(b, groups, cpg, h, w) - mean.reshape(b, groups, 1, 1, 1)
    del y
    out = ((d * s).reshape(x.shape) + beta.double()[:, None, None]
           ).bfloat16()
    ge = g.double().reshape(b, groups, cpg, h, w)
    ds = (ge * d).sum(dim=(3, 4), keepdim=True)
    dd = ge * s
    dweight = (ds * r5).sum(dim=0).reshape(c)
    dbeta = ge.sum(dim=(0, 3, 4)).reshape(c)
    dr = (ds * weight.double().reshape(groups, cpg, 1, 1)).sum(
        dim=2).reshape(b, groups, 1)
    dvar = -0.5 * dr * r5.reshape(b, groups, 1) ** 3
    dmean = -dd.sum(dim=(2, 3, 4)).reshape(b, groups, 1) - 2 * mean * dvar
    q = (d + mean.reshape(b, groups, 1, 1, 1)).reshape(b, groups, -1)
    dq = (2 * (dvar / n) * q + dmean / n).reshape(x.shape)
    dx = (dd.reshape(x.shape).bfloat16().double()
          + dq.bfloat16().double()).bfloat16()
    dbias = dx.double().sum(dim=(0, 2, 3)).bfloat16().float()
    stats = torch.cat([mean, var], dim=-1)
    return out, stats, dx, dbias, dweight, dbeta


def gn_against_chain(got, x, bias, weight, beta, g, groups: int,
                     eps: float) -> dict:
    """The GroupNorm kernels' outputs ``got`` (y, stats, dx, dbias,
    dweight, dbeta) for bf16 ``x`` and cotangent ``g`` against the op
    chain's on the same device and ``gn_chain64``'s. Raises unless: each
    output has the chain's dtype and layout; y is within one bf16 ulp of
    the chain's at the scale of the normalize's terms, off the float64
    output in no more values than the chain's, and within one ulp of it at
    that scale (in bf16 steps an output near 0, where the shift cancels
    the product, sits as far from the float64 one in the chain as in the
    kernel: both steps are reported, and neither is a limit); the
    mean and variance are no farther from float64 ones than the chain's,
    group by group; dx is off the float64 dx in no more values than the
    chain's; dbias, dweight and dbeta are no farther from the float64 ones
    than the chain's in their worst channel. Returns each reading as
    (kernel, chain) where it has two."""
    chain = [*bf16_round.group_norm_bf16_plain(x, bias, weight, beta,
                                               groups, eps)]
    chain += bf16_round.group_norm_bf16_grad_plain(g, x, chain[1], bias,
                                                   weight, groups, eps)
    ref = gn_chain64(x, bias, weight, beta, g, groups, eps)
    for i, (k, c) in enumerate(zip(got, chain)):
        if (k.shape, k.dtype, k.stride()) != (c.shape, c.dtype, c.stride()):
            raise AssertionError(f"GroupNorm output {i}: {k.dtype} "
                                 f"{tuple(k.shape)} {k.stride()}, the "
                                 f"chain's {c.dtype} {c.stride()}")
    steps = bf16_steps(got[0], chain[0])
    rec = {"out_differ": int((steps > 0).sum()),
           "out_steps_from_chain": int(steps.max()),
           "out_ulps_at_scale": gn_ulps_at_scale(
               got[0], chain[0], x, bias, weight, beta, chain[1], groups,
               eps)}
    for i, name in ((0, "out"), (2, "dx")):
        rec[f"{name}_off_f64"] = [int((t[i] != ref[i]).sum())
                                  for t in (got, chain)]
        rec[f"{name}_steps_off_f64"] = [int(bf16_steps(t[i], ref[i]).max())
                                        for t in (got, chain)]
    rec["out_ulps_off_f64"] = [gn_ulps_at_scale(
        t[0], ref[0], x, bias, weight, beta, ref[1], groups, eps)
        for t in (got, chain)]
    for j, name in ((0, "mean"), (1, "var")):
        k, c = ((t[1][..., j].double() - ref[1][..., j]).abs()
                for t in (got, chain))
        rec[f"{name}_off_f64"] = [float(k.max()), float(c.max())]
        rec[f"{name}_groups_farther"] = int((k > c).sum())
    for i, name in ((3, "dbias"), (4, "dweight"), (5, "dbeta")):
        rec[f"{name}_off_f64"] = [float((t[i].double() - ref[i]).abs().max())
                                  for t in (got, chain)]
    del chain, ref
    failed = [name for name, bad in (
        ("out_ulps_at_scale", rec["out_ulps_at_scale"] > 1.0),
        ("out_off_f64", rec["out_off_f64"][0] > rec["out_off_f64"][1]),
        ("out_ulps_off_f64", rec["out_ulps_off_f64"][0] > 1.0),
        ("mean", rec["mean_groups_farther"] > 0),
        ("var", rec["var_groups_farther"] > 0),
        ("dx_off_f64", rec["dx_off_f64"][0] > rec["dx_off_f64"][1]),
        *((name, rec[f"{name}_off_f64"][0] > rec[f"{name}_off_f64"][1])
          for name in ("dbias", "dweight", "dbeta"))) if bad]
    if failed:
        raise AssertionError(f"GroupNorm kernels {list(x.shape)}, {groups} "
                             f"groups, against the op chain: {failed} "
                             f"failed; {rec}")
    return rec


def time_gn_kernels(dev) -> dict:
    """Both bf16 GroupNorm kernels at ``GN_SHAPE``, beside their bound (4
    and 6 bytes an element), the plain op chain and aten's GroupNorm on
    bf16 (``F.group_norm`` and its backward op; they round once and take
    no conv bias: a yardstick only). Before the times, every output of
    both kernels there against the op chain's and a float64 chain's
    (``gn_against_chain``, which raises where a kernel falls short)."""
    b, c, h, w = GN_SHAPE
    x = (torch.randn(GN_SHAPE, device=dev) * 2.0 + 0.3).bfloat16()
    g = torch.randn(GN_SHAPE, device=dev).bfloat16()
    bias, beta = (0.1 * torch.randn(c, device=dev) for _ in range(2))
    weight = 1.0 + 0.1 * torch.randn(c, device=dev)
    n, args = x.numel(), (GN_GROUPS, motion_cnn.GN_EPS)
    y, stats = bf16_round.group_norm_bf16(x, bias, weight, beta, *args)
    got = (y, stats, *bf16_round.group_norm_bf16_bwd(g, x, stats, bias,
                                                     weight, *args))
    check = gn_against_chain(got, x, bias, weight, beta, g, *args)
    del y, got
    log(f"  group_norm_bf16 {list(GN_SHAPE)} against the op chain: out "
        f"{check['out_differ']} values ({100 * check['out_differ'] / n:.4f}"
        f" %) apart, by at most {check['out_steps_from_chain']} steps, "
        f"within {check['out_ulps_at_scale']:.3f} ulp at the terms' scale; "
        f"off the float64 chain (kernel / chain): out values "
        f"{check['out_off_f64']}, steps {check['out_steps_off_f64']}, ulps "
        f"at the terms' scale {check['out_ulps_off_f64']}; mean "
        f"{check['mean_off_f64']}, var {check['var_off_f64']}; dx values "
        f"{check['dx_off_f64']}, steps {check['dx_steps_off_f64']}; dbias "
        f"{check['dbias_off_f64']}, dweight {check['dweight_off_f64']}, "
        f"dbeta {check['dbeta_off_f64']}")
    wb, bb = weight.bfloat16(), beta.bfloat16()
    _, mean, rstd = torch.ops.aten.native_group_norm(x, wb, bb, b, c, h * w,
                                                     GN_GROUPS, args[1])
    recs = {}
    for name, n_bytes, kernel, plain, library in (
            ("group_norm_bf16_fwd", 4 * n,
             lambda: bf16_round.group_norm_bf16(x, bias, weight, beta, *args),
             lambda: bf16_round.group_norm_bf16_plain(x, bias, weight, beta,
                                                      *args),
             lambda: F.group_norm(x, GN_GROUPS, wb, bb, args[1])),
            ("group_norm_bf16_bwd", 6 * n,
             lambda: bf16_round.group_norm_bf16_bwd(g, x, stats, bias, weight,
                                                    *args),
             lambda: bf16_round.group_norm_bf16_grad_plain(
                 g, x, stats, bias, weight, *args),
             lambda: torch.ops.aten.native_group_norm_backward(
                 g, x, mean, rstd, wb, b, c, h * w, GN_GROUPS,
                 [True, True, True]))):
        bound_ms, by = bound(n_bytes, 0)
        recs[name] = {"against_chain": check, "ms": median_ms(kernel),
                      "warm_l2_ms": median_ms(kernel, cold=False),
                      "plain_ms": median_ms(plain, iters=5),
                      "library_ms": median_ms(library), "bound_ms": bound_ms,
                      "bound_by": by, "shape": list(GN_SHAPE)}
        r = recs[name]
        log(f"  {name} {r['shape']} bf16: {r['ms']:.4f} ms from a cold L2 "
            f"({r['warm_l2_ms']:.4f} ms back to back) = "
            f"{100 * bound_ms / r['ms']:.1f} % of the bound {bound_ms:.4f} "
            f"ms ({by}); plain op chain {r['plain_ms']:.4f} ms; aten's bf16 "
            f"GroupNorm {r['library_ms']:.4f} ms")
    return recs


# --- batch and serve -------------------------------------------------------

# Phase 8: the lengths of the four concurrent requests, the clips and
# frames of the invariance and multi-clip runs, the batch sizes timed.
BATCH_LENS = (48, 40, 33, 17)
N_CLIPS, CLIP_FRAMES, INVARIANCE_FRAMES = 8, 48, 32
BATCH_SIZES = (1, 2, 4, 8)


def counted(name: str, expected: int, fn):
    """``fn()`` with the offsets kernel's counts set to 0 just before and
    read just after; fails unless it launched ``expected`` times, all the
    packed kernel. Returns (result, launches)."""
    warp_wide.LAUNCHES = warp_wide.LAUNCHES_PACKED = 0
    out = fn()
    torch.cuda.synchronize()
    n, n_packed = warp_wide.LAUNCHES, warp_wide.LAUNCHES_PACKED
    if n != expected or n_packed != expected:
        raise AssertionError(f"{name}: {n} launches ({n_packed} packed) for "
                             f"{expected} batched chunks")
    return out, n


def same_bytes(name: str, got, want) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or not np.array_equal(g, w):
            n = (int((g != w).sum()) if g.shape == w.shape
                 else f"shape {g.shape} vs {w.shape}")
            raise AssertionError(f"{name}: clip {i} differs from "
                                 f"Stabilizer.stabilize_clip ({n} bytes)")


def drive(cfg: StabilizeConfig, model, clips: np.ndarray):
    """A clip batch through the batched step of ``cfg``'s mode."""
    return stab_lib.drive_chunked_batch(
        stab_lib.ChunkStep(cfg, model, batched=True), clips)


def concurrent_requests(engine, clips) -> list:
    """Each clip from its own thread, all at once."""
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(len(clips)) as ex:
        return list(ex.map(engine.stabilize_clip, clips))


def multi_run(cfg, params, clips) -> tuple:
    """stabilize_multi over in-memory readers and writers: (outputs,
    seconds, stage totals)."""
    writers = [MemWriter(len(c), c.shape[1:]) for c in clips]
    timer = StageTimer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = stabilize_multi(cfg, params, [MemReader(c) for c in clips],
                          writers, timer=timer, device="cuda")
    wall = time.perf_counter() - t0
    if not res.ok or res.frames_written != [len(c) for c in clips]:
        raise AssertionError(f"stabilize_multi: {res}")
    return ([w.frames for w in writers], wall,
            {k: v["total_s"] for k, v in timer.summary().items()})


def serve_roundtrip(cfg, params, clip: np.ndarray, work_dir: str) -> dict:
    """One mp4 POSTed to a localhost server on the card: the response's
    container equals encoding the single-clip output of the decoded
    upload. Returns the response's details."""
    import threading
    import urllib.request
    from dvsg_tpu_torch import serve
    from dvsg_tpu_torch.utils import video_io

    def encode(path, frames):
        with video_io.VideoWriter(path, frames.shape[2], frames.shape[1],
                                  fps=24.0) as w:
            w.write_batch(frames)
        with open(path, "rb") as f:
            return f.read()

    payload = encode(os.path.join(work_dir, "up.mp4"), clip)
    with video_io.VideoReader(os.path.join(work_dir, "up.mp4")) as r:
        decoded = r.read_batch(len(clip) + 1)
    want = encode(os.path.join(work_dir, "want.mp4"), stab_lib.Stabilizer(
        cfg, params, device="cuda").stabilize_clip(decoded))
    engine = BatchStabilizer(cfg, params, max_batch=8, window_s=0.005,
                             device="cuda")
    srv = serve.make_server("127.0.0.1", 0, engine, "chip-smoke")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        req = urllib.request.Request(url + "/stabilize", data=payload,
                                     method="POST")
        warp_wide.LAUNCHES = 0
        with urllib.request.urlopen(req, timeout=300) as r:
            status, frames, body = r.status, r.headers["X-Frames"], r.read()
        launches = warp_wide.LAUNCHES
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()
        engine.close()
    if status != 200 or frames != str(len(decoded)) or body != want:
        raise AssertionError(f"serve: status {status}, {frames} frames, "
                             f"response equal {body == want}")
    if launches != math.ceil(len(decoded) / T_CHUNK):
        raise AssertionError(f"serve: {launches} launches")
    if health["device"] != str(engine.device):
        raise AssertionError(f"serve /healthz: {health}")
    return {"frames": len(decoded), "upload_bytes": len(payload),
            "response_bytes": len(body), "launches": launches,
            "healthz": health}


@torch.inference_mode()
def batch_step_times(cfg, model, clips: np.ndarray, dev) -> dict:
    """Per batched T-chunk at B = 1, 2, 4, 8: ms back to back and queued,
    device frames/s (queued), and the peak device memory of one B = 8
    step."""
    out = {}
    for b in BATCH_SIZES:
        frames = stab_lib.put_frames(clips[:b, :T_CHUNK], dev)
        halos = torch.stack([stab_lib.initial_halo(cfg, c[0], dev)
                             for c in clips[:b]])
        step = stab_lib.ChunkStep(cfg, model, batched=True)
        fn = lambda: step(frames, halos)
        rec = {"b2b_ms": b2b_ms(fn), "queued_ms": queued_ms(fn)}
        rec["device_fps"] = 1e3 * T_CHUNK * b / rec["queued_ms"]
        rec["b2b_fps"] = 1e3 * T_CHUNK * b / rec["b2b_ms"]
        if b == BATCH_SIZES[-1]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn()
            torch.cuda.synchronize()
            rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
            rec["peak_mem_above_inputs_bytes"] = \
                torch.cuda.max_memory_allocated() - base
        out[b] = rec
        del frames, halos
    return out


@torch.inference_mode()
def no_host_sync_batched(cfgs, model, clips: np.ndarray, dev) -> None:
    """The batched smoothed and lag steps over four clips, once each
    after a warm-up call, under ``set_sync_debug_mode("error")``."""
    b = 4
    frames = stab_lib.put_frames(clips[:b, :T_CHUNK], dev)
    halos = torch.stack([stab_lib.initial_halo(cfgs["causal"], c[0], dev)
                         for c in clips[:b]])
    steps = (stab_lib.ChunkStep(cfgs["causal"], model, batched=True),
             stab_lib.ChunkStep(cfgs["lag"], model, batched=True))
    for step in steps:
        step(frames, halos)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(frames, halos)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


def phase_batch(seed: int, dev, work_dir: str):
    """Batch and serve, both presets, 1280x720: the concurrent engine, the
    multi-clip driver and the serving round trip byte-equal to the
    single-clip path with one offsets-kernel launch per batched chunk;
    batch-size and chunk-size invariance; the batched step's times and
    peak memory; stabilize_multi end to end. Returns (launches of the
    offsets kernel in these runs, results)."""
    clips = np.stack([make_clip(seed + 40 + i, CLIP_FRAMES, HEIGHT, WIDTH,
                                dev)[0] for i in range(N_CLIPS)])
    reqs = [clips[i, :n] for i, n in enumerate(BATCH_LENS)]
    chunks = math.ceil(max(BATCH_LENS) / T_CHUNK)
    lag_chunks = math.ceil((max(BATCH_LENS) + LAG) / T_CHUNK)
    inv = clips[:, :INVARIANCE_FRAMES]
    try:
        import cv2  # noqa: F401 — the server decodes and encodes with it
        have_cv2 = True
    except ImportError:
        have_cv2 = False
    launches = 0
    results = {}
    for preset, ckpt in PRESETS:
        params, mcfg = load_npz(os.path.join(ROOT, "checkpoints", ckpt))
        base = StabilizeConfig(model=mcfg, chunk_frames=T_CHUNK)
        cfgs = {"plain": base, "causal": base.replace(path_smooth=SMOOTH),
                "lag": base.replace(path_smooth=SMOOTH,
                                    path_smooth_lag=LAG)}
        want = {m: [stab_lib.Stabilizer(c, params, device="cuda")
                    .stabilize_clip(r) for r in reqs]
                for m, c in cfgs.items()}
        res = {"engine": {}, "multi": {}}
        for mode, cfg in cfgs.items():
            engine = BatchStabilizer(cfg, params, max_batch=len(reqs),
                                     window_s=10.0, device="cuda")
            try:
                got, n = counted(f"[{preset} {mode}] BatchStabilizer",
                                 lag_chunks if cfg.path_smooth_lag
                                 else chunks,
                                 lambda: concurrent_requests(engine, reqs))
                stats = dict(engine.stats)
            finally:
                engine.close()
            launches += n
            if stats["batches"] != 1 or stats["max_group"] != len(reqs):
                raise AssertionError(f"[{preset} {mode}] engine {stats}")
            same_bytes(f"[{preset} {mode}] BatchStabilizer", got,
                       want[mode])
            res["engine"][mode] = {"launches": n, "stats": stats}
            if mode != "lag":
                (got, _, _), n = counted(
                    f"[{preset} {mode}] stabilize_multi", chunks,
                    lambda: multi_run(cfg, params, reqs))
                launches += n
                same_bytes(f"[{preset} {mode}] stabilize_multi", got,
                           want[mode])
                res["multi"][mode] = {"launches": n}
        log(f"  [{preset}] {len(reqs)} concurrent requests "
            f"({', '.join(map(str, BATCH_LENS))} frames) through "
            f"BatchStabilizer: one group, plain / causal / lag == "
            f"stabilize_clip bytewise, {chunks} / {chunks} / {lag_chunks} "
            f"launches; stabilize_multi plain / causal == stabilize_clip, "
            f"{chunks} launches each")

        # Batch-size and chunk-size invariance, bytewise.
        model = stab_lib.build_model(mcfg, params, dev)
        inv_res = {}
        for mode, cfg in cfgs.items():
            single = [stab_lib.Stabilizer(cfg, params, device="cuda")
                      .stabilize_clip(c) for c in inv]
            n_chunks = math.ceil((INVARIANCE_FRAMES + cfg.path_smooth_lag)
                                 / T_CHUNK)
            for b in BATCH_SIZES:
                out, n = counted(f"[{preset} {mode}] B={b}", n_chunks,
                                 lambda: drive(cfg, model, inv[:b]))
                launches += n
                same_bytes(f"[{preset} {mode}] batch of {b}", out,
                           single[:b])
            # T = 8 against 16 (a lag of at most 8 frames fits both).
            short = cfg.replace(path_smooth_lag=min(cfg.path_smooth_lag, 8))
            t8, t16 = (stab_lib.Stabilizer(short.replace(chunk_frames=t),
                                           params, device="cuda")
                       .stabilize_clip(inv[0]) for t in (8, T_CHUNK))
            if not np.array_equal(t8, t16):
                raise AssertionError(
                    f"[{preset} {mode}] T=8 differs from T={T_CHUNK} in "
                    f"{int((t8 != t16).sum())} bytes")
            inv_res[mode] = {"chunks": n_chunks}
        res["invariance"] = inv_res
        no_host_sync_batched(cfgs, model, clips, dev)
        log(f"  [{preset}] {N_CLIPS} clips of {INVARIANCE_FRAMES} frames: "
            f"each clip's bytes equal in batches of "
            f"{', '.join(map(str, BATCH_SIZES))} and alone, and at T = 8 "
            f"and {T_CHUNK} (plain, causal, lag 8); one launch per batched "
            f"chunk; no host sync in the batched smoothed and lag steps")

        # Times of the batched step, and peak memory at B = 8.
        times = {m: batch_step_times(cfgs[m], model, clips, dev)
                 for m in ("plain", "causal")}
        res["step"] = times
        for m, by_b in times.items():
            log(f"  [{preset} {m}] batched step per T={T_CHUNK} chunk, ms "
                f"back to back / queued (device frames/s): " + "; ".join(
                    f"B={b} {r['b2b_ms']:.4f} / {r['queued_ms']:.4f} "
                    f"({r['device_fps']:.1f})" for b, r in by_b.items()))
        peaks = [t[BATCH_SIZES[-1]] for t in times.values()]
        log(f"  [{preset}] peak device memory of one B={BATCH_SIZES[-1]} "
            f"step, plain / causal: " + " / ".join(
                f"{p['peak_mem_bytes'] / 2**30:.3f} GiB "
                f"({p['peak_mem_above_inputs_bytes'] / 2**30:.3f} GiB above "
                f"what was allocated before it)" for p in peaks))
        del model

        # stabilize_multi end to end on all clips, beside the same clips one
        # after another through the sync stream, in turns.
        runs = {"multi": [], "sequential": []}
        for kind in ("multi", "sequential", "sequential", "multi"):
            if kind == "multi":
                _, wall, stages = multi_run(base, params, list(clips))
            else:
                stab = stab_lib.Stabilizer(base, params, device="cuda")
                timer = StageTimer()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for c in clips:
                    stab.stabilize_stream(MemReader(c), MemWriter(
                        len(c), c.shape[1:]), timer=timer)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                stages = {k: v["total_s"]
                          for k, v in timer.summary().items()}
            runs[kind].append({"s": wall, "fps": clips.shape[0]
                               * clips.shape[1] / wall, "stage_s": stages})
        res["e2e"] = runs
        log(f"  [{preset}] {N_CLIPS} clips x {CLIP_FRAMES} frames end to "
            f"end, frames/s: stabilize_multi "
            + " / ".join(f"{r['fps']:.1f}" for r in runs["multi"])
            + " (" + ", ".join(f"{k} {1e3 * v:.1f} ms" for k, v in
                               runs["multi"][0]["stage_s"].items())
            + "); one clip after another (sync stream) "
            + " / ".join(f"{r['fps']:.1f}" for r in runs["sequential"])
            + " (" + ", ".join(f"{k} {1e3 * v:.1f} ms" for k, v in
                               runs["sequential"][0]["stage_s"].items())
            + ")")
        if preset == "fast":
            if have_cv2:
                warp_wide.LAUNCHES_PACKED = 0
                rec = serve_roundtrip(base, params, clips[0, :24], work_dir)
                launches += rec["launches"]
                res["serve"] = rec
                log(f"  [{preset}] serve: one {rec['frames']}-frame mp4 "
                    f"({rec['upload_bytes']} bytes) POSTed to a localhost "
                    f"server: 200, response container == the single-clip "
                    f"output encoded, {rec['launches']} launches; /healthz "
                    f"device {rec['healthz']['device']}")
            else:
                res["serve"] = None
                log("  serve: not driven (OpenCV does not import here; the "
                    "server decodes and encodes uploads with it)")
        results[preset] = res
    return launches, results


# --- parallel and export --------------------------------------------------

# Phase 9: the clips of the clip-sharded and export checks, the ranks that
# share the card over gloo, the steps of the data-parallel train checks.
P9_CLIPS, P9_FRAMES, P9_RANKS, P9_STEPS = 4, 48, 2, 2


def frame_hashes(frames: np.ndarray) -> list:
    return [hashlib.sha1(np.ascontiguousarray(f).tobytes()).hexdigest()
            for f in frames]


def same_hashes(name: str, got: list, want: list) -> None:
    bad = sum(g != w for g, w in zip(got, want))
    if len(got) != len(want) or bad:
        raise AssertionError(f"{name}: {bad} of {len(want)} frames differ "
                             f"from one process ({len(got)} frames)")


def p9_clips(seed: int, dev) -> np.ndarray:
    return np.stack([make_clip(seed + 90 + i, P9_FRAMES, HEIGHT, WIDTH,
                               dev)[0] for i in range(P9_CLIPS)])


def p9_train_cfg(mcfg, seed: int) -> TrainConfig:
    return TrainConfig(model=mcfg, batch_size=TRAIN_BATCH, steps=10,
                       warmup_steps=2, learning_rate=TRAIN_LR, seed=seed)


def timed(fn):
    """(fn(), seconds on the host clock, the card synchronized on both
    sides)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms: its default backward sums in an
    order that varies from run to run, and two runs of one step are held
    to the last bit here."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def dp_steps(state, tcfg, seed: int, step) -> dict:
    """``P9_STEPS`` steps ``step(generator)`` on ``state``: every loss, and
    the parameters and gradients of the first step (its rate is the
    schedule's first, 0) and the parameters after the last."""
    def host(tensors):
        return {k: v.detach().cpu().numpy().copy() for k, v in tensors}

    out = {"losses": []}
    for i in range(P9_STEPS):
        out["losses"].append(float(step(train_loop.step_generator(
            seed, i))["total"]))
        if i == 0:
            out["grads"] = host((k, p.grad) for k, p in
                                state.model.named_parameters())
            out["params0"] = host(state.params.items())
    out["params"] = host(state.params.items())
    return out


def _p9_rank(rank: int, n: int, store: str, work_dir: str, seed: int,
             device: str) -> None:
    """One of the ranks that share ``device`` over gloo: temporal (plain,
    causal) and clip-sharded (plain) stabilization and the data-parallel
    train step, both presets; writes frame hashes, losses, parameters and
    times for the parent to hold against one process."""
    import pickle
    import torch.distributed as dist
    from dvsg_tpu_torch.parallel import dryrun
    from dvsg_tpu_torch.parallel import mesh as mesh_lib
    from dvsg_tpu_torch.parallel.temporal import TemporalShardedStabilizer

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dryrun.join_group(rank, n, store, "gloo", timeout_s=300)
    try:
        mesh = mesh_lib.make_mesh(device=dev)
        if mesh.backend != "gloo" or mesh.size != n:
            raise AssertionError(f"mesh {mesh}")
        clips = p9_clips(seed, dev)
        res = {}
        for preset, ckpt in PRESETS:
            params, mcfg = load_npz(os.path.join(ROOT, "checkpoints", ckpt))
            base = StabilizeConfig(model=mcfg, chunk_frames=T_CHUNK)
            r = {}
            for mode, cfg in (("plain", base),
                              ("causal", base.replace(path_smooth=SMOOTH))):
                temporal = TemporalShardedStabilizer(cfg, params, mesh)
                temporal.stabilize_clip(clips[0, :T_CHUNK])      # warm-up
                warp_wide.LAUNCHES = 0
                out, wall = timed(lambda: temporal.stabilize_clip(clips[0]))
                r[f"temporal_{mode}"] = {
                    "hashes": frame_hashes(out),
                    "launches": warp_wide.LAUNCHES,
                    "chunk_ms": 1e3 * wall / (P9_FRAMES // T_CHUNK)}
            warp_wide.LAUNCHES = 0
            out = dp.ShardedClipStabilizer(base, params, mesh
                                           ).stabilize_clips(clips)
            r["sharded_plain"] = {"hashes": [frame_hashes(c) for c in out],
                                  "launches": warp_wide.LAUNCHES}
            tcfg = p9_train_cfg(mcfg, seed)
            state = dp.replicate_state(
                train_loop.build_state(tcfg, params, dev), mesh)
            step_fn, shard_batch = dp.make_dp_train_step(tcfg, mesh)
            r["dp"] = dp_steps(state, tcfg, seed, lambda gen: step_fn(
                state, shard_batch(gen)))
            res[preset] = r
        with open(os.path.join(work_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def phase_parallel_export(seed: int, dev, work_dir: str):
    """Parallel and export, both presets, 1280x720: a world of one over
    NCCL (clip-sharded plain, causal and lag; temporal plain and causal;
    the data-parallel train step), two ranks sharing cuda:0 over gloo
    (temporal, clip-sharded, the train step), and exported chunk programs
    saved, loaded and run (plain and causal single-clip, a batch of four).
    Returns (B1 launches, B2/B3 launches, results)."""
    import pickle
    import torch.distributed as dist
    from dvsg_tpu_torch import export as export_lib
    from dvsg_tpu_torch.parallel import dryrun
    from dvsg_tpu_torch.parallel import mesh as mesh_lib
    from dvsg_tpu_torch.parallel.temporal import TemporalShardedStabilizer

    clips = p9_clips(seed, dev)
    n_chunks = math.ceil(P9_FRAMES / T_CHUNK)
    launches, results, want = 0, {}, {}
    train_counts = {k: 0 for k in train_launches()}

    # (a) A world of one over NCCL.
    dryrun.join_group(0, 1, os.path.join(work_dir, "nccl_store"), "nccl",
                      timeout_s=300)
    try:
        mesh = mesh_lib.make_mesh(device=dev)
        if mesh.backend != "nccl":
            raise AssertionError(f"world of one on {mesh.backend}")
        for preset, ckpt in PRESETS:
            params, mcfg = load_npz(os.path.join(ROOT, "checkpoints", ckpt))
            base = StabilizeConfig(model=mcfg, chunk_frames=T_CHUNK)
            cfgs = {"plain": base, "causal": base.replace(path_smooth=SMOOTH),
                    "lag": base.replace(path_smooth=SMOOTH,
                                        path_smooth_lag=LAG)}
            w = want[preset] = {
                m: [stab_lib.Stabilizer(c, params, device="cuda")
                    .stabilize_clip(x) for x in clips]
                for m, c in cfgs.items()}
            res = {"sharded": {}, "temporal": {}}
            for mode, cfg in cfgs.items():
                expect = math.ceil((P9_FRAMES + cfg.path_smooth_lag)
                                   / T_CHUNK)
                sharded = dp.ShardedClipStabilizer(cfg, params, mesh)
                out, n = counted(
                    f"[{preset} {mode}] ShardedClipStabilizer (NCCL, one "
                    f"rank)", expect, lambda: sharded.stabilize_clips(clips))
                launches += n
                same_bytes(f"[{preset} {mode}] ShardedClipStabilizer", out,
                           w[mode])
                res["sharded"][mode] = {"launches": n}
            for mode in ("plain", "causal"):
                temporal = TemporalShardedStabilizer(cfgs[mode], params, mesh)
                out, n = counted(
                    f"[{preset} {mode}] TemporalShardedStabilizer (NCCL, one "
                    f"rank)", n_chunks,
                    lambda: temporal.stabilize_clip(clips[0]))
                launches += n
                same_bytes(f"[{preset} {mode}] TemporalShardedStabilizer",
                           [out], w[mode][:1])
                _, wall = timed(lambda: temporal.stabilize_clip(clips[0]))
                res["temporal"][mode] = {
                    "launches": n, "chunk_ms": 1e3 * wall / n_chunks}

            # The data-parallel train step against train_step.
            tcfg = p9_train_cfg(mcfg, seed)
            one = train_loop.build_state(tcfg, params, dev)
            state = dp.replicate_state(
                train_loop.build_state(tcfg, params, dev), mesh)
            step_fn, shard_batch = dp.make_dp_train_step(tcfg, mesh)
            with deterministic_cudnn():
                for step in range(P9_STEPS):
                    gen = lambda: train_loop.step_generator(seed, step)
                    reset_train_launches()
                    a = train_loop.train_step(one, gen(), tcfg)
                    b = step_fn(state, shard_batch(gen()))
                    torch.cuda.synchronize()
                    used = train_launches()
                    if any(v != 2 for v in used.values()):
                        raise AssertionError(f"[{preset}] train_step and the "
                                             f"DP step launched {used}")
                    for k, v in used.items():
                        train_counts[k] += v // 2
                    if float(a["total"]) != float(b["total"]):
                        raise AssertionError(
                            f"[{preset}] DP step loss {float(b['total'])!r} "
                            f"!= train_step {float(a['total'])!r}")
            for (k, x), y in zip(one.params.items(), state.params.values()):
                if not torch.equal(x, y):
                    raise AssertionError(f"[{preset}] DP step parameter {k} "
                                         "differs from train_step")
            # Step times, draws included in both, five of each in turns.
            steps = {
                "train_step": lambda: train_loop.train_step(
                    one, train_loop.step_generator(seed, 0), tcfg),
                "dp_step": lambda: step_fn(state, shard_batch(
                    train_loop.step_generator(seed, 0)))}
            step_s = {k: [] for k in steps}
            for kind in ("train_step", "dp_step", "dp_step", "train_step"):
                step_s[kind] += [timed(steps[kind])[1] for _ in range(5)]
            res["train"] = {f"{k}_ms": 1e3 * float(np.median(v))
                            for k, v in step_s.items()}
            res["train"]["bit_equal_steps"] = P9_STEPS
            results[preset] = res
            log(f"  [{preset}] NCCL world of one: ShardedClipStabilizer "
                f"({P9_CLIPS} clips x {P9_FRAMES} frames) plain / causal / "
                f"lag == stabilize_clip bytewise, one launch per batched "
                f"chunk; TemporalShardedStabilizer plain / causal == "
                f"stabilize_clip, {n_chunks} launches, "
                f"{res['temporal']['plain']['chunk_ms']:.2f} / "
                f"{res['temporal']['causal']['chunk_ms']:.2f} ms a chunk end "
                f"to end; DP train step == train_step to the last bit over "
                f"{P9_STEPS} steps (deterministic cuDNN), one B2 and one B3 "
                f"pair a step; step {res['train']['dp_step_ms']:.2f} ms vs "
                f"train_step {res['train']['train_step_ms']:.2f} ms")
    finally:
        dist.destroy_process_group()

    # The one-process losses and parameters the two ranks are held to: the
    # same steps again through train_step (cuDNN's default algorithms, as
    # the ranks run).
    one_process = {}
    for preset, ckpt in PRESETS:
        params, mcfg = load_npz(os.path.join(ROOT, "checkpoints", ckpt))
        tcfg = p9_train_cfg(mcfg, seed)
        one = train_loop.build_state(tcfg, params, dev)
        one_process[preset] = dp_steps(one, tcfg, seed, lambda gen:
                                       train_loop.train_step(one, gen, tcfg))

    # (b) Two ranks sharing cuda:0 over gloo (NCCL takes one rank a card),
    # spawned: this process has CUDA initialized.
    from dvsg_tpu_torch.parallel.dryrun import run_ranks
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_ranks(_p9_rank, P9_RANKS, args=(P9_RANKS, os.path.join(
        work_dir, "gloo_store"), work_dir, seed, str(dev)), timeout_s=600)
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r in range(P9_RANKS):
        with open(os.path.join(work_dir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    for preset, _ in PRESETS:
        w, res = want[preset], results[preset]
        res["two_ranks"] = {"spawn_s": spawn_s}
        for r, got in enumerate(ranks):
            g = got[preset]
            for mode in ("plain", "causal"):
                same_hashes(f"[{preset} {mode}] temporal, rank {r} of "
                            f"{P9_RANKS}", g[f"temporal_{mode}"]["hashes"],
                            frame_hashes(w[mode][0]))
                if g[f"temporal_{mode}"]["launches"] != n_chunks:
                    raise AssertionError(
                        f"[{preset} {mode}] temporal rank {r}: "
                        f"{g[f'temporal_{mode}']['launches']} launches")
            for i in range(P9_CLIPS):
                same_hashes(f"[{preset}] sharded clip {i}, rank {r}",
                            g["sharded_plain"]["hashes"][i],
                            frame_hashes(w["plain"][i]))
            if g["sharded_plain"]["launches"] != n_chunks:
                raise AssertionError(f"[{preset}] sharded rank {r}: "
                                     f"{g['sharded_plain']['launches']} "
                                     f"launches")
            # A step within 1e-6 of the parameters and 1e-5 of the loss
            # (tests/test_parallel.py's bounds); its gradient, summed over
            # the ranks in another order, within 1e-3 of each tensor's
            # largest (cuDNN's backward sums in a run-dependent order).
            # After the second step's first real update the parameters are
            # recorded, not held: Adam's g/sqrt(v) amplifies the rounding
            # of near-zero gradients.
            ref, got = one_process[preset], g["dp"]
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(
                got["losses"], ref["losses"]))
            param_abs = max(float(np.abs(got["params0"][k] - v).max())
                            for k, v in ref["params0"].items())
            grad_rel = max(float(np.abs(got["grads"][k] - v).max())
                           / max(float(np.abs(v).max()), 1e-30)
                           for k, v in ref["grads"].items())
            last_abs = max(float(np.abs(got["params"][k] - v).max())
                           for k, v in ref["params"].items())
            if loss_rel > 1e-5 or param_abs > 1e-6 or grad_rel > 1e-3:
                raise AssertionError(
                    f"[{preset}] DP step over {P9_RANKS} ranks: loss "
                    f"{loss_rel:.2e} relative, parameters {param_abs:.2e}, "
                    f"gradients {grad_rel:.2e}")
            res["two_ranks"][f"rank{r}"] = {
                "temporal_chunk_ms": {m: g[f"temporal_{m}"]["chunk_ms"]
                                      for m in ("plain", "causal")},
                "dp_loss_rel": loss_rel, "dp_param_abs": param_abs,
                "dp_grad_rel": grad_rel,
                f"dp_param_abs_after_{P9_STEPS}_steps": last_abs}
        log(f"  [{preset}] {P9_RANKS} gloo ranks sharing cuda:0 "
            f"(spawned, {spawn_s:.1f} s): temporal plain / causal and "
            f"clip-sharded plain == one process bytewise on every rank, "
            f"{n_chunks} launches a rank; temporal chunk end to end "
            + ", ".join(f"rank {r} {v['temporal_chunk_ms']['plain']:.2f} / "
                        f"{v['temporal_chunk_ms']['causal']:.2f} ms"
                        for r, v in ((r, res["two_ranks"][f"rank{r}"])
                                     for r in range(P9_RANKS)))
            + f"; DP steps: loss within {loss_rel:.2e}, first step's "
            f"parameters {param_abs:.2e}, gradients {grad_rel:.2e} of the "
            f"largest; parameters after {P9_STEPS} steps {last_abs:.2e} "
            f"(rank {P9_RANKS - 1})")

    # (c) Export on the card.
    for preset, ckpt in PRESETS:
        params, mcfg = load_npz(os.path.join(ROOT, "checkpoints", ckpt))
        base = StabilizeConfig(model=mcfg, chunk_frames=T_CHUNK)
        model = stab_lib.build_model(mcfg, params, dev)
        res = results[preset]["export"] = {}
        for mode, cfg in (("plain", base),
                          ("causal", base.replace(path_smooth=SMOOTH))):
            path = os.path.join(work_dir, f"{preset}_{mode}.dvsgt")
            exp = export_lib.export_chunk_program(cfg, params, HEIGHT, WIDTH,
                                                  device=dev)
            export_lib.save_exported(exp, path, cfg)
            loaded = export_lib.load_exported(path)
            out, n = counted(f"[{preset} {mode}] exported program", n_chunks,
                             lambda: loaded.stabilize_clip(clips[0]))
            launches += n
            same_bytes(f"[{preset} {mode}] exported program", [out],
                       want[preset][mode][:1])
            with torch.inference_mode():
                frames = stab_lib.put_frames(clips[0, :T_CHUNK], dev)
                halo = stab_lib.initial_halo(cfg, clips[0, 0], dev)
                state = pathsmooth.initial_state(dev)
                live = ((lambda: stab_lib.stabilize_chunk_smooth_impl(
                            cfg, model, frames, halo, state))
                        if cfg.path_smooth else
                        (lambda: stab_lib.stabilize_chunk_impl(
                            cfg, model, frames, halo)))
                art = lambda: loaded.chunk(frames, halo, state)
                times = {}
                for name, fn in (("live", live), ("artifact", art),
                                 ("artifact", art), ("live", live)):
                    times.setdefault(name, []).append(
                        {"b2b_ms": b2b_ms(fn), "queued_ms": queued_ms(fn)})
            res[mode] = {"launches": n, "export_s": exp.export_s,
                         "artifact_bytes": os.path.getsize(path),
                         "chunk_ms": times}
            log(f"  [{preset} {mode}] exported in {exp.export_s:.1f} s, "
                f"{os.path.getsize(path)} bytes; the artifact == "
                f"stabilize_clip bytewise, {n} launches; chunk ms back to "
                f"back / queued, live then artifact: " + "; ".join(
                    f"{k} " + ", ".join(f"{t['b2b_ms']:.3f} / "
                                        f"{t['queued_ms']:.3f}" for t in v)
                    for k, v in times.items()))
        if preset == "fast":
            path = os.path.join(work_dir, "fast_batch.dvsgt")
            exp = export_lib.export_batch_program(base, params, P9_CLIPS,
                                                  HEIGHT, WIDTH, device=dev)
            export_lib.save_exported(exp, path, base)
            loaded = export_lib.load_exported(path)
            live = drive(base, model, clips)
            out, n = counted(f"[{preset}] batch artifact B={P9_CLIPS}",
                             n_chunks, lambda: loaded.stabilize_clips(clips))
            launches += n
            same_bytes(f"[{preset}] batch artifact", out, live)
            res["batch"] = {"launches": n, "export_s": exp.export_s,
                            "artifact_bytes": os.path.getsize(path)}
            log(f"  [{preset}] batch artifact B={P9_CLIPS}: exported in "
                f"{exp.export_s:.1f} s, {os.path.getsize(path)} bytes, == "
                f"the live batched step bytewise, {n} launches")
        del model
    return launches, train_counts, results


# --- bf16 compute, the stacked arch and the profiler -------------------------

# Phase 10: the clip of the bf16 and stacked checks, that of the profiled
# streams, the 1080p soak chain's length in chunks, the training steps of
# each check.
P10_FRAMES, PROFILE_FRAMES = 32, 96
SOAK_CHUNKS, SOAK_SIZE = 24, (1080, 1920)
STACKED_STEPS, BF16_TRAIN_STEPS = 20, 12
# The card's bf16 offsets against the CPU port's, over the card's own
# bf16-to-f32 gap: measured 0.517 (fast) and 0.532 (quality) on an H100.
# The two sum their convolutions in other orders, and bf16 rounding
# amplifies each one-ulp difference layer by layer (tests/test_torch_bf16.py
# holds the CPU port to the reference's bf16 the same way).
BF16_GAP_SHARE = 0.75
# The bf16 kernel step against the plain step, (loss, worst gradient)
# relative to the plain step's: measured 7.5e-6 / 6.7e-3 (fast) and
# 6.9e-7 / 7.2e-3 (quality) in one run on an NVIDIA H100 80GB HBM3 at
# 700 W (the f32 warps' few-ulp differences, rounded again in the bf16
# backward).
BF16_STEP_TOL = (1e-4, 2e-2)


def bf16_cfg(mcfg):
    return dataclasses.replace(mcfg, dtype="bfloat16")


@torch.inference_mode()
def chunk_offsets(stab, clip: np.ndarray, dev) -> torch.Tensor:
    """The offsets of ``clip``'s first chunk through ``stab``'s step."""
    frames = stab_lib.put_frames(clip[:T_CHUNK], dev)
    return stab_lib.stabilize_chunk_impl(
        stab.cfg, stab.model, frames, stab._initial_halo(clip[0]))[2]


def timed_steps(state, cfg, seed: int, first: int, n: int):
    """``n`` train steps from step ``first``, each timed on the host clock
    between device synchronizations: (loss terms of each step, median ms
    from the third step on)."""
    history, walls = [], []
    for step in range(first, first + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = train_loop.train_step(
            state, train_loop.step_generator(seed, step), cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        history.append({k: float(v) for k, v in aux.items()})
    return history, 1e3 * float(np.median(walls[2:]))


def phase_bf16_stacked(seed: int, dev, work_dir: str):
    """bf16 compute at both presets' full width, the 1080p bf16 soak, the
    stacked arch at the presets' widths (stabilize, train, export), bf16
    training and the profiler on the sync and overlapped streams. Returns
    (offsets-kernel launches, training-kernel launches, results); the
    results hold the GELU and GroupNorm kernels' launches in the bf16
    training runs."""
    from dvsg_tpu_torch import cli
    from dvsg_tpu_torch import export as export_lib
    from dvsg_tpu_torch.utils import profiling
    clip, still, _ = make_clip(seed + 10, P10_FRAMES, HEIGHT, WIDTH, dev)
    small, _, _ = make_clip(seed + 11, 20, 180, 320, dev)
    n_chunks = math.ceil(P10_FRAMES / T_CHUNK)
    launches = 0
    train_counts = {k: 0 for k in train_launches()}
    gelu_counts = {k: 0 for k in gelu_launches()}
    gn_counts = {k: 0 for k in gn_launches()}
    results = {}

    def exported(name, cfg, params, want):
        nonlocal launches
        path = os.path.join(work_dir, f"{name.replace(' ', '_')}.dvsgt")
        exp = export_lib.export_chunk_program(cfg, params, HEIGHT, WIDTH,
                                              device=dev)
        export_lib.save_exported(exp, path, cfg)
        loaded = export_lib.load_exported(path)
        hdr = loaded.cfg.model
        if loaded.cfg != cfg:
            raise AssertionError(f"{name}: header config {loaded.cfg}")
        out, n = counted(f"{name} artifact", n_chunks,
                         lambda: loaded.stabilize_clip(clip))
        launches += n
        same_bytes(f"{name} artifact", [out], [want])
        log(f"  [{name}] artifact ({hdr.dtype}, {hdr.arch}) exported "
            f"in {exp.export_s:.1f} s, {os.path.getsize(path)} bytes, == "
            f"the live path bytewise, {n} launches")
        return {"export_s": exp.export_s,
                "bytes": os.path.getsize(path), "launches": n}

    # (a) bf16 at both presets' full width, 1280x720, T = 16.
    for preset, ckpt in PRESETS:
        params, mcfg = load_npz(os.path.join(ROOT, "checkpoints", ckpt))
        cfg32 = StabilizeConfig(model=mcfg, chunk_frames=T_CHUNK)
        cfg = cfg32.replace(model=bf16_cfg(mcfg))
        stab = stab_lib.Stabilizer(cfg, params, device="cuda")
        stab32 = stab_lib.Stabilizer(cfg32, params, device="cuda")
        out, n = counted(f"[{preset} bf16] stabilize_clip", n_chunks,
                         lambda: stab.stabilize_clip(clip))
        launches += n
        if out.shape != clip.shape or out.dtype != np.uint8:
            raise AssertionError(f"bf16 output {out.shape} {out.dtype}")

        # Offsets: card bf16 against the CPU port's bf16, over the card's
        # own bf16-to-f32 gap, on the first chunk.
        cpu = stab_lib.Stabilizer(cfg, params, device="cpu")
        o_card = chunk_offsets(stab, clip, dev).cpu()
        o_cpu = chunk_offsets(cpu, clip, torch.device("cpu"))
        o_32 = chunk_offsets(stab32, clip, dev).cpu()
        err = float((o_card - o_cpu).abs().max())
        gap = float((o_card - o_32).abs().max())
        share = err / gap
        # Frames: card bf16 against the CPU port's bf16, on a small clip
        # and on the first 720p chunk.
        got, ref = stab.stabilize_clip(small), cpu.stabilize_clip(small)
        diff = np.abs(got.astype(np.int16) - ref)
        beyond = float((diff > 1).mean())
        d720 = np.abs(out[:T_CHUNK].astype(np.int16)
                      - cpu.stabilize_clip(clip[:T_CHUNK]))
        beyond720 = float((d720 > 1).mean())
        log(f"  [{preset} bf16] offsets card vs CPU port {err:.3e}, card "
            f"bf16 vs f32 {gap:.3e}: {share:.3f} of the gap (held <= "
            f"{BF16_GAP_SHARE}); frames card vs CPU on {small.shape}: max "
            f"{int(diff.max())} LSB, {100 * beyond:.4f} % beyond 1 LSB; on "
            f"the first 720p chunk: max {int(d720.max())} LSB, "
            f"{100 * beyond720:.4f} % beyond 1 LSB")
        if not share <= BF16_GAP_SHARE:
            raise AssertionError(f"[{preset} bf16] offsets {share:.3f} of "
                                 "the bf16 gap")

        # Byte identity: T = 8 against 16, batch 1 against 2, resume.
        t8 = stab_lib.Stabilizer(cfg.replace(chunk_frames=8), params,
                                 device="cuda").stabilize_clip(clip)
        same_bytes(f"[{preset} bf16] T=8 vs 16", [t8], [out])
        pair = np.stack([clip, clip[::-1].copy()])
        with torch.inference_mode():
            b2 = drive(cfg, stab.model, pair)
            b1 = drive(cfg, stab.model, pair[:1])
        same_bytes(f"[{preset} bf16] batch 2", [b2[0], b1[0]], [out, out])
        resumed, written, _ = interrupted_then_resumed(stab, clip, 1)
        same_bytes(f"[{preset} bf16] resumed at {written}", [resumed], [out])
        res = {"launches": n, "offsets_err": err, "offsets_gap": gap,
               "gap_share": share, "frames_max_lsb": int(diff.max()),
               "frames_beyond_1lsb": beyond,
               "frames_720p_max_lsb": int(d720.max()),
               "frames_720p_beyond_1lsb": beyond720}
        res["artifact"] = exported(f"{preset} bf16", cfg, params, out)

        # Times: chunk back to back and queued, encoder queued, f32 and
        # bf16 in turns.
        with torch.inference_mode():
            frames = stab_lib.put_frames(clip[:T_CHUNK], dev)
            halo = stab._initial_halo(clip[0])
            mh, mw = mcfg.model_size
            seq = torch.cat([halo, resize_ops.downscale_norm(frames, mh,
                                                             mw)])
            turns = []
            for tag, s in (("f32", stab32), ("bf16", stab)):
                turns += [
                    (f"chunk_b2b_{tag}", lambda s=s: b2b_ms(
                        lambda: stab_lib.stabilize_chunk_impl(
                            s.cfg, s.model, frames, halo))),
                    (f"chunk_queued_{tag}", lambda s=s: queued_ms(
                        lambda: stab_lib.stabilize_chunk_impl(
                            s.cfg, s.model, frames, halo))),
                    (f"encoder_queued_{tag}", lambda s=s: queued_ms(
                        lambda: motion_cnn.encode_frames(s.model, seq)))]
            times = {}
            for name, fn in [*turns, *turns[::-1]]:
                times.setdefault(name, []).append(fn())
            # One chunk of each under the profiler: the elementwise
            # kernels' share of its device time (bf16's GELU is one kernel
            # of csrc/bf16_round.cu, not counted here; f32's is one fused
            # PyTorch kernel).
            shares = {}
            for tag, s in (("f32", stab32), ("bf16", stab)):
                trace_dir = os.path.join(work_dir, f"chunk_{preset}_{tag}")
                with profiling.trace(trace_dir, dev):
                    stab_lib.stabilize_chunk_impl(s.cfg, s.model, frames,
                                                  halo)
                summ = profiling.summarize_trace(trace_dir, min_us=0.0)
                busy = profiling.device_busy_stats(trace_dir)["busy_ms"]
                elem = sum(v["total_ms"] for k, v in summ.items()
                           if "elementwise" in k)
                shares[tag] = {"elementwise_ms": elem, "busy_ms": busy}
        res["times_ms"] = times
        res["elementwise"] = shares
        log(f"  [{preset}] one chunk profiled: elementwise kernels "
            + ", ".join(f"{t} {v['elementwise_ms']:.3f} of "
                        f"{v['busy_ms']:.3f} ms busy "
                        f"({100 * v['elementwise_ms'] / v['busy_ms']:.1f} %)"
                        for t, v in shares.items()))
        log(f"  [{preset}] per T={T_CHUNK} chunk at {WIDTH}x{HEIGHT}, ms in "
            "turns: " + "; ".join(
                f"{k} " + ", ".join(f"{v:.4f}" for v in vs)
                for k, vs in times.items()))
        if preset == "fast":
            warp_wide.LAUNCHES = 0
            m = eval_lib.evaluate_synthetic(
                stab, torch.Generator().manual_seed(seed + 7), EVAL_FRAMES,
                *EVAL_SIZE)
            launches += warp_wide.LAUNCHES
            log(f"  [fast bf16] eval {EVAL_FRAMES} frames: psnr_gain_db "
                f"{m['psnr_gain_db']:+.3f}, stability_gain "
                f"{m['stability_gain']:.3f}")
            if not m["psnr_gain_db"] > 0:
                raise AssertionError("bf16 eval gains no PSNR")
            res["eval"] = {k: float(v) for k, v in m.items()}
        results[f"{preset}_bf16"] = res
        del stab, stab32, cpu

    # (b) bf16 fast at 1920x1080: a device-resident chain of chunks.
    params, mcfg = load_npz(os.path.join(ROOT, "checkpoints",
                                         dict(PRESETS)["fast"]))
    cfg = StabilizeConfig(model=bf16_cfg(mcfg), chunk_frames=T_CHUNK)
    stab = stab_lib.Stabilizer(cfg, params, device="cuda")
    soak, _, _ = make_clip(seed + 12, T_CHUNK, *SOAK_SIZE, dev)
    stall, _ = _stall_and_flush(dev)
    with torch.inference_mode():
        frames = stab_lib.put_frames(soak, dev)
        halo = stab._initial_halo(soak[0])
        warp_wide.LAUNCHES = 0
        events, peaks, held = [], [], []
        ranges = torch.empty(SOAK_CHUNKS, 2, dtype=torch.uint8, device=dev)
        for k in range(SOAK_CHUNKS):
            # Queued behind a long product: each event pair reads the
            # device's time for its chunk, not the host's time to issue it.
            stall()
            torch.cuda.reset_peak_memory_stats(dev)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out, halo, _ = stab_lib.stabilize_chunk_impl(cfg, stab.model,
                                                         frames, halo)
            ev[1].record()
            events.append(ev)
            peaks.append(torch.cuda.max_memory_allocated(dev))
            held.append(torch.cuda.memory_allocated(dev))
            ranges[k].copy_(torch.stack(torch.aminmax(out)))
            del out
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in events]
        live = [tuple(r) for r in ranges.tolist()]
    launches += warp_wide.LAUNCHES
    q = SOAK_CHUNKS // 4
    first_q, last_q = float(np.mean(ms[1:q + 1])), float(np.mean(ms[-q:]))
    peak_first, peak_last = max(peaks[1:q + 1]), max(peaks[-q:])
    log(f"  [fast bf16 1080p] {SOAK_CHUNKS} chunks of {T_CHUNK}: ms first "
        f"quarter {first_q:.4f}, last quarter {last_q:.4f}; peak memory, "
        f"bytes: chunk 1 {peaks[0]} (no carried halo yet), first quarter "
        f"{peak_first}, last quarter {peak_last}; held after each chunk "
        f"{sorted(set(held))}; output range "
        f"{min(a for a, _ in live)}..{max(b for _, b in live)}; "
        f"{warp_wide.LAUNCHES} launches")
    if warp_wide.LAUNCHES != SOAK_CHUNKS:
        raise AssertionError(f"soak: {warp_wide.LAUNCHES} launches")
    if last_q > 1.05 * first_q:
        raise AssertionError(f"soak drifts: {first_q:.4f} -> {last_q:.4f}")
    if peak_last > peak_first:
        raise AssertionError("soak peak memory grows along the chain")
    if any(lo == hi for lo, hi in live):
        raise AssertionError("soak output went flat")
    results["soak_1080p_bf16"] = {"chunk_ms": ms, "peak_bytes": peaks,
                                  "held_bytes": held,
                                  "first_quarter_ms": first_q,
                                  "last_quarter_ms": last_q}
    del stab

    # (c) The stacked arch at the presets' widths, from a seeded init:
    # 20 train steps at batch 8, then stabilize and export the result.
    for preset, ckpt in PRESETS:
        _, mcfg = load_npz(os.path.join(ROOT, "checkpoints", ckpt))
        smcfg = dataclasses.replace(mcfg, arch="stacked")
        tcfg = TrainConfig(model=smcfg, batch_size=TRAIN_BATCH,
                           steps=STACKED_STEPS, learning_rate=TRAIN_LR,
                           seed=seed, checkpoint_every=0)
        history = []
        reset_train_launches()
        state = train_loop.train(tcfg, log_every=0, device="cuda",
                                 history=history)
        torch.cuda.synchronize()
        for k, v in expect_launches(f"{preset} stacked",
                                    STACKED_STEPS).items():
            train_counts[k] += v
        check_history(f"{preset} stacked", history, STACKED_STEPS,
                      falls=False)
        step_check = kernels_vs_plain_step(state, tcfg, STACKED_STEPS)
        _, step_ms = timed_steps(state, tcfg, seed, STACKED_STEPS, 10)
        log(f"  [{preset} stacked] one step through the kernels vs the "
            f"plain versions: loss rel {step_check['loss_rel']:.1e}, worst "
            f"gradient rel {step_check['grad_rel']:.1e}; step "
            f"{step_ms:.3f} ms = {1e3 / step_ms:.2f} steps/s")
        params = {k: v.detach().cpu() for k, v in state.params.items()}
        del state
        cfg = StabilizeConfig(model=smcfg, chunk_frames=T_CHUNK)
        stab = stab_lib.Stabilizer(cfg, params, device="cuda")
        out, n = counted(f"[{preset} stacked] stabilize_clip", n_chunks,
                         lambda: stab.stabilize_clip(clip))
        launches += n
        cpu = stab_lib.Stabilizer(cfg, params, device="cpu")
        cpu_lsb = max(lsb(stab.stabilize_clip(small),
                          cpu.stabilize_clip(small)),
                      lsb(out[:T_CHUNK], cpu.stabilize_clip(clip[:T_CHUNK])))
        moved = float(np.abs(out.astype(np.int16) - clip).mean())
        with torch.inference_mode():
            frames = stab_lib.put_frames(clip[:T_CHUNK], dev)
            halo = stab._initial_halo(clip[0])
            chunk = lambda: stab_lib.stabilize_chunk_impl(  # noqa: E731
                cfg, stab.model, frames, halo)
            chunk_ms = {"b2b": [b2b_ms(chunk), b2b_ms(chunk)],
                        "queued": [queued_ms(chunk), queued_ms(chunk)]}
        log(f"  [{preset} stacked] card vs CPU on {small.shape} and the "
            f"first 720p chunk: max {cpu_lsb} LSB; mean |out - in| "
            f"{moved:.3f}; chunk ms back to back {chunk_ms['b2b']}, queued "
            f"{chunk_ms['queued']}")
        if cpu_lsb > 1:
            raise AssertionError(f"[{preset} stacked] card vs CPU {cpu_lsb} "
                                 "LSB")
        results[f"{preset}_stacked"] = {
            "history": history, "kernels_vs_plain": step_check,
            "step_ms": step_ms, "chunk_ms": chunk_ms,
            "card_vs_cpu_max_lsb": cpu_lsb, "launches": n,
            "artifact": exported(f"{preset} stacked", cfg, params, out)}
        del stab

    # (d) bf16 training at both presets' widths, batch 8.
    for preset, ckpt in PRESETS:
        _, mcfg = load_npz(os.path.join(ROOT, "checkpoints", ckpt))
        tcfg = TrainConfig(model=bf16_cfg(mcfg), batch_size=TRAIN_BATCH,
                           steps=BF16_TRAIN_STEPS, learning_rate=TRAIN_LR,
                           seed=seed, checkpoint_every=0)
        state = train_loop.init_state(
            tcfg, torch.Generator().manual_seed(seed), device="cuda")
        reset_train_launches()
        bf16_round.LAUNCHES_GELU_FWD = bf16_round.LAUNCHES_GELU_BWD = 0
        bf16_round.LAUNCHES_GN_FWD = bf16_round.LAUNCHES_GN_BWD = 0
        history, step_ms = timed_steps(state, tcfg, seed, 0,
                                       BF16_TRAIN_STEPS)
        for k, v in expect_launches(f"{preset} bf16 train",
                                    BF16_TRAIN_STEPS).items():
            train_counts[k] += v
        for k, v in expect_gelu_launches(f"{preset} bf16 train", tcfg.model,
                                         BF16_TRAIN_STEPS).items():
            gelu_counts[k] += v
        for k, v in expect_gn_launches(f"{preset} bf16 train", tcfg.model,
                                       BF16_TRAIN_STEPS).items():
            gn_counts[k] += v
        check_history(f"{preset} bf16 train", history, BF16_TRAIN_STEPS,
                      falls=False)
        step_check = kernels_vs_plain_step(state, tcfg, BF16_TRAIN_STEPS,
                                           *BF16_STEP_TOL)
        log(f"  [{preset} bf16 train] step {step_ms:.3f} ms = "
            f"{1e3 / step_ms:.2f} steps/s; kernels vs plain: loss rel "
            f"{step_check['loss_rel']:.1e}, worst gradient rel "
            f"{step_check['grad_rel']:.1e}")
        results[f"{preset}_bf16_train"] = {
            "history": history, "step_ms": step_ms,
            "steps_per_s": 1e3 / step_ms, "kernels_vs_plain": step_check}
        del state

    # (e) The profiler: the CLI's trace and [profile] lines around the
    # fast model's sync and overlapped streams of the 720p clip.
    params, mcfg = load_npz(os.path.join(ROOT, "checkpoints",
                                         dict(PRESETS)["fast"]))
    stab = stab_lib.Stabilizer(StabilizeConfig(model=mcfg,
                                               chunk_frames=T_CHUNK),
                               params, device="cuda")
    clip, _, _ = make_clip(seed + 13, PROFILE_FRAMES, HEIGHT, WIDTH, dev)
    n_chunks = math.ceil(PROFILE_FRAMES / T_CHUNK)
    stream_run(stab, clip, overlapped=False)            # warm
    for overlapped in (False, True):
        tag = "overlapped" if overlapped else "sync"
        trace_dir = os.path.join(work_dir, f"profile_{tag}")
        warp_wide.LAUNCHES = 0
        with profiling.trace(trace_dir, dev):
            stream_run(stab, clip, overlapped)
        launches += warp_wide.LAUNCHES
        summary = profiling.summarize_trace(trace_dir)
        busy = profiling.device_busy_stats(trace_dir)
        b1 = {k: v for k, v in summary.items()
              if "warp_u8_offsets_packed_kernel" in k}
        log(f"  [fast {tag}] profile of the stream ({n_chunks} chunks), "
            "stabilize --profile-dir's lines:")
        cli._print_profile(trace_dir)
        if [v["count"] for v in b1.values()] != [n_chunks]:
            raise AssertionError(f"[{tag}] B1's packed kernel in the trace: "
                                 f"{b1}")
        if busy is None:
            raise AssertionError(f"[{tag}] no device lane in the trace")
        results[f"profile_{tag}"] = {"top8": dict(list(summary.items())[:8]),
                                     "b1": b1, "busy": busy}
    results["gelu_launches"] = gelu_counts
    results["gn_launches"] = gn_counts
    return launches, train_counts, results


# --- staging, export for the card, tensor parallelism, examples, quality ----

# Phase 11: the staging chunk, the cross-exported artifacts' clip, the TP
# check's windows and ranks (sharing cuda:0 over gloo), its offsets
# tolerance (the reference's, tests/test_parallel.py), and the port's
# examples with the small arguments of tests/test_torch_examples.py and the
# line each must print (the last field: needs OpenCV).
STAGING_SHAPE = (T_CHUNK, HEIGHT, WIDTH, 3)
P11_FRAMES, TP_WINDOWS, TP_RANKS, TP_TOL = 48, 8, 2, 2e-5
EXAMPLES = (
    ("01_library_quickstart.py", ("--frames", "12"), "gain +", False),
    ("02_streaming_online.py", ("--frames", "9", "--chunk-frames", "4"),
     "done: 9/9 stabilized frames", False),
    ("03_serve_client.py", (), "stabilized ", True),
    ("04_batch_data_parallel.py", (), "stabilized 8 clips", False),
    ("05_finetune_on_footage.py", ("--steps", "4"), "on held-out footage:",
     True),
    ("06_export_deploy.py", ("--frames", "8"),
     "stabilized 8 frames from the artifact", False),
    ("06_export_deploy.py", ("--frames", "8", "--for-device", "cuda"),
     "stabilized 8 frames from the artifact", False),
    ("07_path_smoothing.py", ("--frames", "32", "--horizon", "16"),
     "path_smooth=16", True))
# A process that sees no card exports for the card through the CLI.
_NO_CARD_EXPORT = ("import sys, torch; assert not torch.cuda.is_available(), "
                   "'the exporting process sees a card'; from "
                   "dvsg_tpu_torch.cli import main; sys.exit(main("
                   "sys.argv[1:]))")


def host_line() -> str:
    """The host's CPU model and core count (host-clock times depend on
    them)."""
    import platform
    model = platform.processor() or "CPU model not reported"
    try:
        with open("/proc/cpuinfo") as f:
            fields = dict(line.split(":", 1) for line in f if ":" in line)
        model = next(fields[k].strip() for k in ("model name\t", "Model\t",
                                                  "CPU part\t")
                     if k in fields)
    except (OSError, StopIteration, ValueError):
        pass
    return (f"{platform.machine()} {model}, nproc {os.cpu_count()} "
            f"({len(os.sched_getaffinity(0))} usable)")


def host_median_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Median ms of ``iters`` calls on the host clock."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def have_opencv() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def phase11_staging(dev) -> dict:
    """(a) The staging extension against the plain swap on a 720p chunk,
    byte-equal; host times of both in turns; a ``StagingRing`` slot
    filled by ``stack_frames`` and uploaded to the card."""
    from dvsg_tpu_torch.utils import staging
    t0 = time.perf_counter()
    mod = staging.native()
    build_s = time.perf_counter() - t0
    chunk = np.random.default_rng(11).integers(0, 256, STAGING_SHAPE,
                                               dtype=np.uint8)
    ext, plain = staging.bgr_to_rgb(chunk), staging.bgr_to_rgb_plain(chunk)
    if not np.array_equal(ext, plain):
        raise AssertionError("staging: the extension's swap differs from "
                             f"the plain swap on {int((ext != plain).sum())} "
                             "bytes")
    out = np.empty_like(chunk)
    fns = {"extension": lambda: staging.bgr_to_rgb(chunk, out=out),
           "plain": lambda: staging.bgr_to_rgb_plain(chunk, out=out)}
    times = {k: [] for k in fns}
    for k in ("extension", "plain", "plain", "extension"):
        times[k].append(host_median_ms(fns[k]))
    ring = staging.StagingRing(2, STAGING_SHAPE)
    slot = ring.next_slot()
    staging.stack_frames(list(chunk), out=slot)
    if not np.array_equal(slot, chunk):
        raise AssertionError("staging: stack_frames into a ring slot")

    def upload():
        torch.from_numpy(slot).to(dev)
        torch.cuda.synchronize()
    up_ms = host_median_ms(upload)
    if not torch.equal(torch.from_numpy(slot).to(dev).cpu(),
                       torch.from_numpy(chunk)):
        raise AssertionError("staging: the uploaded slot differs")
    res = {"host": host_line(), "pool_size": mod.pool_size(),
           "build_s": build_s, "swap_ms": times, "bytes": chunk.nbytes,
           "ring_upload_ms": up_ms,
           "ring_upload_gb_s": chunk.nbytes / up_ms / 1e6}
    log(f"  staging extension (built in {build_s:.1f} s, pool of "
        f"{res['pool_size']}) == the plain swap on a {STAGING_SHAPE} "
        f"chunk; host ms, medians of 20 in turns: extension "
        + ", ".join(f"{t:.3f}" for t in times["extension"]) + "; plain "
        + ", ".join(f"{t:.3f}" for t in times["plain"])
        + f"; ring slot -> card {up_ms:.3f} ms "
        f"({res['ring_upload_gb_s']:.2f} GB/s); host {res['host']}")
    return res


def phase11_cross_export(seed: int, dev, work_dir: str):
    """(b) Both presets exported for the card at 1280x720, T = 16, by a
    process that sees no card (``export --for-platform cuda``), loaded on
    cuda:0: the artifact's frames byte-equal to ``stabilize_clip`` with one
    launch a chunk; its queued chunk time beside the live chunk's."""
    from dvsg_tpu_torch import export as export_lib
    clip = make_clip(seed + 110, P11_FRAMES, HEIGHT, WIDTH, dev)[0]
    n_chunks = math.ceil(P11_FRAMES / T_CHUNK)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = []
    t0 = time.perf_counter()
    for preset, _ in PRESETS:
        path = os.path.join(work_dir, f"{preset}_for_card.dvsgt")
        procs.append((preset, path, subprocess.Popen(
            [sys.executable, "-c", _NO_CARD_EXPORT, "export", "--preset",
             preset, "--size", str(HEIGHT), str(WIDTH), "--chunk-frames",
             str(T_CHUNK), "--for-platform", "cuda", "--output", path],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    for preset, _, proc in procs:
        out, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"[{preset}] export --for-platform cuda in "
                                 f"a process without a card failed "
                                 f"({proc.returncode}):\n{err[-3000:]}")
        log(f"  [{preset}] no-card process: {out.strip().splitlines()[-1]}")
    export_s = time.perf_counter() - t0
    launches, res = 0, {"export_both_s": export_s}
    for (preset, ckpt), (_, path, _) in zip(PRESETS, procs):
        params, mcfg = load_npz(os.path.join(ROOT, "checkpoints", ckpt))
        cfg = StabilizeConfig(model=mcfg, chunk_frames=T_CHUNK)
        loaded = export_lib.load_exported(path)
        if loaded.device != dev or loaded.meta["device"] != "cuda:0":
            raise AssertionError(f"[{preset}] artifact for "
                                 f"{loaded.meta['device']} on {loaded.device}")
        live = stab_lib.Stabilizer(cfg, params, device=dev)
        want = live.stabilize_clip(clip)
        out, n = counted(f"[{preset}] artifact exported without a card",
                         n_chunks, lambda: loaded.stabilize_clip(clip))
        launches += n
        same_bytes(f"[{preset}] artifact exported without a card", [out],
                   [want])
        with torch.inference_mode():
            frames = stab_lib.put_frames(clip[:T_CHUNK], dev)
            halo = stab_lib.initial_halo(cfg, clip[0], dev)
            fns = {"live": lambda: stab_lib.stabilize_chunk_impl(
                       cfg, live.model, frames, halo),
                   "artifact": lambda: loaded.chunk(frames, halo)}
            times = {k: [] for k in fns}
            for k in ("live", "artifact", "artifact", "live"):
                times[k].append(queued_ms(fns[k]))
        res[preset] = {"launches": n, "queued_chunk_ms": times,
                       "artifact_bytes": os.path.getsize(path)}
        log(f"  [{preset}] artifact exported for the card without one "
            f"({os.path.getsize(path)} bytes) == stabilize_clip bytewise "
            f"on cuda:0, {n} launches; queued chunk ms, live "
            + ", ".join(f"{t:.4f}" for t in times["live"]) + ", artifact "
            + ", ".join(f"{t:.4f}" for t in times["artifact"]))
        del loaded, live
    return launches, res


def _p11_tp_rank(rank: int, n: int, store: str, work_dir: str, seed: int,
                 device: str) -> None:
    """One of the TP ranks sharing ``device`` over gloo on a (1, n) mesh:
    both presets' offsets through the sharded model against the unsharded
    one, a 720p chunk through ``TPStabilizer`` against ``stabilize_clip``,
    and the chunk's time sharded and not."""
    import pickle
    import torch.distributed as dist
    from dvsg_tpu_torch.parallel import dryrun, tp
    from dvsg_tpu_torch.parallel import mesh as mesh_lib

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    stab_lib.exact_math()
    dryrun.join_group(rank, n, store, "gloo", timeout_s=300)
    try:
        mesh = mesh_lib.make_mesh((1, n), axis_names=("data", "model"),
                                  device=dev)
        clip = make_clip(seed + 111, T_CHUNK, HEIGHT, WIDTH, dev)[0]
        rng = np.random.default_rng(seed + 112)
        res = {}
        for preset, ckpt in PRESETS:
            params, mcfg = load_npz(os.path.join(ROOT, "checkpoints", ckpt))
            cfg = StabilizeConfig(model=mcfg, chunk_frames=T_CHUNK)
            mh, mw = mcfg.model_size
            windows = torch.from_numpy(
                rng.random((TP_WINDOWS, mh, mw, 3 * mcfg.window),
                           np.float32) - 0.5).to(dev)
            plain = stab_lib.Stabilizer(cfg, params, device=dev)
            sharded = tp.TPStabilizer(cfg, params, mesh)
            n_sharded = sum(isinstance(m, (tp._GatheredConv,
                                           tp._TPResBlock))
                            for m in sharded.model.modules())
            with torch.inference_mode():
                a = motion_cnn.predict_offsets(plain.model, windows)
                b = motion_cnn.predict_offsets(sharded.model, windows)
            want = plain.stabilize_clip(clip)
            got = sharded.stabilize_clip(clip)                 # warm-up
            warp_wide.LAUNCHES = 0
            got, tp_s = timed(lambda: sharded.stabilize_clip(clip))
            n_launch = warp_wide.LAUNCHES
            _, plain_s = timed(lambda: plain.stabilize_clip(clip))
            d = np.abs(got.astype(int) - want.astype(int))
            res[preset] = {"offsets_err": float((a - b).abs().max()),
                           "offsets_max": float(a.abs().max()),
                           "sharded_modules": n_sharded,
                           "lsb": int(d.max()),
                           "share_off": float((d > 0).mean()),
                           "launches": n_launch, "tp_chunk_ms": 1e3 * tp_s,
                           "plain_chunk_ms": 1e3 * plain_s}
        with open(os.path.join(work_dir, f"tp{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def phase11_tp(seed: int, dev, work_dir: str) -> dict:
    """(c) Tensor parallelism: two gloo ranks sharing cuda:0 on a (1, 2)
    ("data", "model") mesh, both presets at full width: offsets within
    ``TP_TOL`` of the unsharded model, a 720p chunk within 1 LSB of
    ``stabilize_clip`` with one launch, the chunk's time against
    unsharded (no gate)."""
    import pickle
    from dvsg_tpu_torch.parallel.dryrun import run_ranks
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_ranks(_p11_tp_rank, TP_RANKS, args=(TP_RANKS, os.path.join(
        work_dir, "tp_store"), work_dir, seed, str(dev)), timeout_s=900)
    res = {"spawn_s": time.perf_counter() - t0}
    for r in range(TP_RANKS):
        with open(os.path.join(work_dir, f"tp{r}.pkl"), "rb") as f:
            got = pickle.load(f)
        for preset, g in got.items():
            if (g["offsets_err"] > TP_TOL or g["lsb"] > 1
                    or g["launches"] != 1 or g["sharded_modules"] < 1
                    or g["offsets_max"] < 1e-4):
                raise AssertionError(f"[{preset}] TP rank {r} of "
                                     f"{TP_RANKS}: {g}")
            log(f"  [{preset}] TP rank {r} of {TP_RANKS} (gloo, cuda:0): "
                f"{g['sharded_modules']} sharded modules, offsets within "
                f"{g['offsets_err']:.2e} of unsharded (|max| "
                f"{g['offsets_max']:.3f}), 720p chunk {g['lsb']} LSB from "
                f"stabilize_clip ({g['share_off']:.2e} of bytes off), "
                f"{g['launches']} launch; chunk {g['tp_chunk_ms']:.1f} ms "
                f"sharded vs {g['plain_chunk_ms']:.1f} ms unsharded, end to "
                f"end")
            res[f"{preset}_rank{r}"] = g
    return res


def phase11_examples(dev, work_dir: str) -> dict:
    """(d) Every port example as a subprocess on ``dev``'s device type, all
    started together, each checked for its line; those needing OpenCV only
    where it imports."""
    cv2_ok = have_opencv()
    procs, res = [], {}
    for script, args, line, needs_cv2 in EXAMPLES:
        name = " ".join((script,) + args)
        if needs_cv2 and not cv2_ok:
            log(f"  {name}: not run, OpenCV does not import here")
            res[name] = "not run: no OpenCV"
            continue
        if script.startswith("03"):
            args += ("--out", os.path.join(work_dir, "served.mp4"))
        procs.append((name, line, time.perf_counter(), subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "examples", "torch",
                                          script), *args, "--device",
             dev.type], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    for name, line, t0, proc in procs:
        out, err = proc.communicate(timeout=900)
        if proc.returncode != 0 or line not in out:
            raise AssertionError(f"example {name} on {dev.type}: exit "
                                 f"{proc.returncode}, no {line!r} in its "
                                 f"output:\n{out[-1500:]}\n{err[-3000:]}")
        said = next(x for x in out.splitlines() if line in x)
        res[name] = {"s": time.perf_counter() - t0, "line": said}
        log(f"  {name}: {said}")
    return res


def phase11_quality(dev) -> dict:
    """(e) The quality table's sway and handheld rows on the card, held to
    the gates of tests/test_torch_quality_table.py."""
    import importlib.util
    if not have_opencv():
        log("  quality table: not run, OpenCV does not import here")
        return {"not run": "no OpenCV"}
    spec = importlib.util.spec_from_file_location(
        "quality_table_torch", os.path.join(ROOT, "scripts",
                                            "quality_table_torch.py"))
    qt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qt)
    params, mcfg = load_npz(os.path.join(ROOT, "checkpoints",
                                         "flagship_fast.npz"))
    rows = {name: qt.measure(name, qt.make_fixture(name, device=dev),
                             params, mcfg, SMOOTH, device=dev)
            for name in ("sway", "handheld")}
    sway, hand = rows["sway"], rows["handheld"]
    gates = {
        "sway stability": sway["stability_smooth"]
        > sway["stability_plain"] + 0.04,
        "sway t_rms": sway["t_rms_smooth"] < 0.60 * sway["t_rms_plain"],
        "sway crop": sway["crop_smooth"] >= 0.99,
        "sway distortion": sway["distortion_smooth"] >= 0.99,
        "handheld stability": hand["stability_smooth"]
        >= hand["stability_plain"] - 0.005,
        "handheld t_rms": hand["t_rms_smooth"] < 0.85 * hand["t_rms_plain"],
        "handheld crop": hand["crop_smooth"] >= 0.995,
        "handheld distortion": hand["distortion_smooth"] >= 0.99}
    for name, row in rows.items():
        log(f"  quality table on the card, {name}: {row}")
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"quality gates failed on the card: {failed}: "
                             f"{rows}")
    return rows


def phase_last_modules(seed: int, dev, work_dir: str):
    """Phase 11: staging, export for the card from a process without one,
    tensor parallelism, the examples and the quality table. Returns (B1
    launches, results)."""
    results = {"staging": phase11_staging(dev)}
    launches, results["cross_export"] = phase11_cross_export(seed, dev,
                                                             work_dir)
    results["tp"] = phase11_tp(seed, dev, work_dir)
    results["examples"] = phase11_examples(dev, work_dir)
    results["quality"] = phase11_quality(dev)
    return launches, results


# --- phase 12: the multi-rank surfaces over NCCL, one rank per card --------

# The DP gates of phase 12, as phase 9 (b)'s: tests/test_parallel.py's own
# bounds (every loss within rtol 1e-5, the first step's parameters within
# 1e-6), the first step's gradient within 1e-3 of each tensor's largest
# (the ranks sum it in another order than one process).
DP_LOSS_RTOL, DP_PARAM_TOL, DP_GRAD_TOL = 1e-5, 1e-6, 1e-3
# The losses are held over the steps phase 9 (b) holds: the first (its
# rate is the schedule's first, 0) and the first update. After it the
# ranks' and one process's parameters part: Adam's m / sqrt(v) amplifies
# the rounding of near-zero gradients, summed in another order; the later
# steps' losses and the last parameters are recorded, not held.
DP_GATED_STEPS = 2
# (e): the seeded mp4s of stabilize-batch under torchrun, and their length.
P12_MP4S, P12_MP4_FRAMES = 4, 32


@dataclasses.dataclass(frozen=True)
class MultiCard:
    """Phase 12's work and its sizes. ``presets``: (name, .npz path); every
    rank drives ``device`` (``cuda``: the card of its rank) in a
    ``backend`` group. The CPU tests run the same code at a small size on
    gloo ranks."""

    presets: tuple
    device: str = "cuda"
    backend: str = "nccl"
    height: int = HEIGHT
    width: int = WIDTH
    chunk: int = T_CHUNK
    clips: int = 8                      # (a): two a rank on four cards
    clip_frames: int = 48
    long_frames: int = 96               # (b): one clip, frames sharded
    temporal_chunks: tuple = (T_CHUNK, 64)
    smooth: int = SMOOTH
    lag: int = LAG
    steps: int = 10                     # (c)
    batch: int = TRAIN_BATCH
    tp_windows: int = TP_WINDOWS        # (d)

    def modes(self, mcfg) -> dict:
        base = StabilizeConfig(model=mcfg, chunk_frames=self.chunk)
        return {"plain": base,
                "causal": base.replace(path_smooth=self.smooth),
                "lag": base.replace(path_smooth=self.smooth,
                                    path_smooth_lag=self.lag)}

    def train_cfg(self, mcfg, seed: int) -> TrainConfig:
        return TrainConfig(model=mcfg, batch_size=self.batch,
                           steps=self.steps, warmup_steps=2,
                           learning_rate=TRAIN_LR, seed=seed)

    def tp_shapes(self, n: int) -> tuple:
        return ((1, n), (2, n // 2))


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def wall_s(dev, fn):
    """(fn(), host seconds), ``dev`` synchronized on both sides."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


class Spans:
    """Time inside the calls of wrapped functions, by name: CUDA events
    around each call on a card, read after a synchronize; the host clock
    on the CPU."""

    def __init__(self, dev):
        self.dev, self.calls = dev, {}

    @contextlib.contextmanager
    def around(self, module, name: str):
        """``module.<name>`` wrapped for the block."""
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            if self.dev.type != "cuda":
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self.calls.setdefault(name, []).append(
                    1e3 * (time.perf_counter() - t0))
                return out
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            self.calls.setdefault(name, []).append((a, b))
            return out

        setattr(module, name, wrapped)
        try:
            yield
        finally:
            setattr(module, name, fn)

    def read(self, name: str) -> tuple:
        """(ms summed, calls) of ``name`` since the last read."""
        sync(self.dev)
        calls = self.calls.pop(name, [])
        return (sum(c if isinstance(c, float) else c[0].elapsed_time(c[1])
                    for c in calls), len(calls))


class ListWriter:
    """In-memory writer that keeps what it is given."""

    def __init__(self):
        self.parts = []

    def write_batch(self, frames: np.ndarray) -> None:
        self.parts.append(np.array(frames))


def rank_counted(mesh, expected: int, fn):
    """``fn()`` on this rank, every rank of ``mesh`` starting together,
    with B1's counts set to 0 just before and read just after: (result,
    host seconds, launches). Raises unless ``expected`` launches, all of
    the packed kernel, on a card (the CPU runs the plain version: none)."""
    import torch.distributed as dist
    dev = mesh.device
    sync(dev)
    dist.barrier(group=mesh.group)
    warp_wide.LAUNCHES = warp_wide.LAUNCHES_PACKED = 0
    out, secs = wall_s(dev, fn)
    n, packed = warp_wide.LAUNCHES, warp_wide.LAUNCHES_PACKED
    want = expected if dev.type == "cuda" else 0
    if n != want or packed != want:
        raise AssertionError(f"rank {mesh.rank}: {n} B1 launches ({packed} "
                             f"packed) for {expected} chunks")
    return out, secs, n


def host_arrays(tensors) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors}


def train_run(state, tcfg, step, keep: bool, group=None) -> dict:
    """``tcfg.steps`` steps ``step(generator)`` on ``state`` under cuDNN's
    deterministic algorithms: every loss, a digest of the parameters after
    the last step, the B2 and B3 launches, steps/s after the first step;
    with ``keep`` also the first step's gradients and parameters and the
    last parameters."""
    import torch.distributed as dist
    dev = next(state.model.parameters()).device
    out, losses = {}, []
    reset_train_launches()
    with deterministic_cudnn():
        for i in range(tcfg.steps):
            if i == 1:
                sync(dev)
                if group is not None:
                    dist.barrier(group=group)
                t0 = time.perf_counter()
            losses.append(float(step(train_loop.step_generator(tcfg.seed,
                                                               i))["total"]))
            if i == 0 and keep:
                out["grads"] = host_arrays((k, p.grad) for k, p in
                                           state.model.named_parameters())
                out["params0"] = host_arrays(state.params.items())
        sync(dev)
        secs = time.perf_counter() - t0
    digest = hashlib.sha1()
    for v in state.params.values():
        digest.update(v.detach().cpu().numpy().tobytes())
    out.update(losses=losses, digest=digest.hexdigest(),
               launches=train_launches(),
               steps_per_s=(tcfg.steps - 1) / secs)
    if keep:
        out["params"] = host_arrays(state.params.items())
    return out


def p12_sharded(spec: MultiCard, mesh, mcfg, params, clips: np.ndarray,
                trace_dir: str) -> dict:
    """(a) on this rank: ``ShardedClipStabilizer`` in every mode and
    ``stabilize_multi(mesh=)`` plain and causal over the whole batch: frame
    hashes, launches, seconds; the device busy share of a plain run."""
    from dvsg_tpu_torch.pipeline.multiclip import stabilize_multi
    from dvsg_tpu_torch.utils import profiling
    out = {}
    modes = spec.modes(mcfg)
    for mode, cfg in modes.items():
        stab = dp.ShardedClipStabilizer(cfg, params, mesh)
        stab.stabilize_clips(clips[:, :spec.chunk])              # warm-up
        chunks = math.ceil((clips.shape[1] + cfg.path_smooth_lag)
                           / spec.chunk)
        got, secs, n = rank_counted(mesh, chunks,
                                    lambda: stab.stabilize_clips(clips))
        out[mode] = {"hashes": [frame_hashes(c) for c in got],
                     "launches": n, "s": secs}
        if mode == "plain":
            with profiling.trace(trace_dir, mesh.device):
                stab.stabilize_clips(clips)
            out["busy"] = profiling.device_busy_stats(trace_dir)
    for mode in ("plain", "causal"):
        writers = [ListWriter() for _ in clips]
        res, secs, n = rank_counted(
            mesh, math.ceil(clips.shape[1] / spec.chunk),
            lambda: stabilize_multi(modes[mode], params,
                                    [MemReader(c) for c in clips], writers,
                                    mesh=mesh))
        out[f"multi_{mode}"] = {
            "hashes": {i: frame_hashes(np.concatenate(w.parts))
                       for i, w in enumerate(writers) if w.parts},
            "written": res.frames_written, "ok": res.ok, "launches": n,
            "s": secs}
    return out


def p12_temporal(spec: MultiCard, mesh, mcfg, params,
                 clip: np.ndarray) -> dict:
    """(b) on this rank: ``TemporalShardedStabilizer`` plain and causal at
    each chunk size: frame hashes, launches, the chunk's host ms and the
    ms inside ``mesh.ring_shift`` and ``mesh.all_gather`` a chunk."""
    from dvsg_tpu_torch.parallel import mesh as mesh_lib
    from dvsg_tpu_torch.parallel.temporal import TemporalShardedStabilizer
    out, spans = {}, Spans(mesh.device)
    for t in spec.temporal_chunks:
        chunks = math.ceil(len(clip) / t)
        for mode in ("plain", "causal"):
            cfg = spec.modes(mcfg)[mode].replace(chunk_frames=t)
            stab = TemporalShardedStabilizer(cfg, params, mesh)
            stab.stabilize_clip(clip[:t])                        # warm-up
            with spans.around(mesh_lib, "ring_shift"), \
                    spans.around(mesh_lib, "all_gather"):
                got, secs, n = rank_counted(
                    mesh, chunks, lambda: stab.stabilize_clip(clip))
                ring, gather = spans.read("ring_shift"), spans.read(
                    "all_gather")
            out[f"{mode}_T{t}"] = {
                "hashes": frame_hashes(got), "launches": n,
                "chunk_ms": 1e3 * secs / chunks,
                "ring_ms": ring[0] / chunks, "ring_calls": ring[1],
                "gather_ms": gather[0] / chunks, "gather_calls": gather[1]}
    return out


def p12_dp(spec: MultiCard, mesh, mcfg, params, seed: int) -> list:
    """(c) on this rank: two runs of the same DP steps from the same
    state (``train_run``); rank 0 keeps the first run's arrays."""
    tcfg = spec.train_cfg(mcfg, seed)
    runs = []
    for run in range(2):
        state = dp.replicate_state(
            train_loop.build_state(tcfg, params, mesh.device), mesh)
        step_fn, shard_batch = dp.make_dp_train_step(tcfg, mesh)
        runs.append(train_run(state, tcfg, lambda gen: step_fn(
            state, shard_batch(gen)), run == 0 and mesh.rank == 0,
            mesh.group))
    return runs


def p12_tp(spec: MultiCard, meshes: dict, mcfg, params, inp: dict,
           ref: dict) -> dict:
    """(d) on this rank, on each mesh: offsets through ``tp_model`` against
    one process's, a chunk through ``TPStabilizer`` against one process's
    ``stabilize_clip``, its host ms and the ms inside
    ``tp.gather_channels``."""
    from dvsg_tpu_torch.parallel import tp
    cfg = StabilizeConfig(model=mcfg, chunk_frames=spec.chunk)
    out = {}
    for shape, m in meshes.items():
        spans = Spans(m.device)
        stab = tp.TPStabilizer(cfg, params, m)
        with torch.inference_mode():
            offs = motion_cnn.predict_offsets(stab.model, torch.from_numpy(
                inp["windows"]).to(m.device)).cpu().numpy()
        stab.stabilize_clip(inp["chunk"])                        # warm-up
        with spans.around(tp, "gather_channels"):
            got, secs, n = rank_counted(m, 1, lambda: stab.stabilize_clip(
                inp["chunk"]))
            gather = spans.read("gather_channels")
        d = np.abs(got.astype(int) - ref["tp_frames"].astype(int))
        out["x".join(map(str, shape))] = {
            "offsets_err": float(np.abs(offs - ref["tp_offsets"]).max()),
            "lsb": int(d.max()), "share_off": float((d > 0).mean()),
            "launches": n, "chunk_ms": 1e3 * secs, "gather_ms": gather[0],
            "gathers": gather[1]}
    return out


def _p12_rank(rank: int, n: int, store: str, work_dir: str,
              spec: MultiCard) -> None:
    """One rank of phase 12: joins the group, drives (a)-(d) for every
    preset on the card of its rank, writes what it got for the parent to
    hold against one process."""
    import pickle
    import torch.distributed as dist
    from dvsg_tpu_torch.parallel import dryrun
    from dvsg_tpu_torch.parallel import mesh as mesh_lib

    if spec.device == "cpu":
        torch.set_num_threads(1)
    dryrun.join_group(rank, n, store, spec.backend, timeout_s=300)
    try:
        mesh = mesh_lib.make_mesh(device=spec.device)
        dev = mesh.device
        if (mesh.backend != spec.backend or mesh.size != n
                or (dev.type == "cuda" and dev.index != rank)):
            raise AssertionError(f"rank {rank}: a mesh of {mesh.size} "
                                 f"{mesh.backend} ranks on {dev}")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            stab_lib.exact_math()
        meshes = {shape: mesh_lib.make_mesh(shape, ("data", "model"), dev)
                  for shape in spec.tp_shapes(n)}
        with open(os.path.join(work_dir, "p12_inputs.pkl"), "rb") as f:
            inputs, refs = pickle.load(f)
        res = {"device": str(dev)}
        for preset, path in spec.presets:
            params, mcfg = load_npz(path)
            res[preset] = {
                "sharded": p12_sharded(spec, mesh, mcfg, params,
                                       inputs["clips"], os.path.join(
                                           work_dir, f"trace{rank}{preset}")),
                "temporal": p12_temporal(spec, mesh, mcfg, params,
                                         inputs["long"]),
                "dp": p12_dp(spec, mesh, mcfg, params, inputs["seed"]),
                "tp": p12_tp(spec, meshes, mcfg, params, inputs[preset],
                             refs[preset])}
        with open(os.path.join(work_dir, f"p12_rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def p12_inputs(spec: MultiCard, seed: int, dev) -> dict:
    """Phase 12's seeded inputs: the clip batch of (a), the long clip of
    (b), the chunk and each preset's model windows of (d)."""
    out = {"seed": seed,
           "clips": np.stack([make_clip(seed + 120 + i, spec.clip_frames,
                                        spec.height, spec.width, dev)[0]
                              for i in range(spec.clips)]),
           "long": make_clip(seed + 130, spec.long_frames, spec.height,
                             spec.width, dev)[0]}
    chunk = make_clip(seed + 131, spec.chunk, spec.height, spec.width,
                      dev)[0]
    rng = np.random.default_rng(seed + 132)
    for preset, path in spec.presets:
        mcfg = load_npz(path)[1]
        mh, mw = mcfg.model_size
        out[preset] = {"chunk": chunk, "windows": rng.random(
            (spec.tp_windows, mh, mw, 3 * mcfg.window), np.float32) - 0.5}
    return out


def p12_references(spec: MultiCard, inputs: dict, dev) -> dict:
    """Phase 12's work in this one process on ``dev``, and its times: the
    frames of ``stabilize_clip`` (hashes; the TP chunk itself), the clip
    batch through ``ShardedClipStabilizer`` on a mesh of this process,
    ``train_step`` (``train_run``), the unsharded offsets."""
    from dvsg_tpu_torch.parallel import mesh as mesh_lib
    one = mesh_lib.make_mesh(device=dev)
    clips, long = inputs["clips"], inputs["long"]
    refs = {}
    for preset, path in spec.presets:
        params, mcfg = load_npz(path)
        modes = spec.modes(mcfg)
        r = refs[preset] = {}
        for mode, cfg in modes.items():
            single = stab_lib.Stabilizer(cfg, params, device=dev)
            r[f"clips_{mode}"] = [frame_hashes(single.stabilize_clip(c))
                                  for c in clips]
            batch = dp.ShardedClipStabilizer(cfg, params, one)
            batch.stabilize_clips(clips[:, :spec.chunk])         # warm-up
            r[f"one_card_{mode}_s"] = wall_s(
                dev, lambda: batch.stabilize_clips(clips))[1]
        for t in spec.temporal_chunks:
            for mode in ("plain", "causal"):
                single = stab_lib.Stabilizer(
                    modes[mode].replace(chunk_frames=t), params, device=dev)
                got = single.stabilize_clip(long)
                secs = wall_s(dev, lambda: single.stabilize_clip(long))[1]
                r[f"long_{mode}_T{t}"] = {
                    "hashes": frame_hashes(got),
                    "chunk_ms": 1e3 * secs / math.ceil(len(long) / t)}
        tcfg = spec.train_cfg(mcfg, inputs["seed"])
        state = train_loop.build_state(tcfg, params, dev)
        r["train"] = train_run(state, tcfg, lambda gen: train_loop.train_step(
            state, gen, tcfg), keep=True)
        single = stab_lib.Stabilizer(modes["plain"], params, device=dev)
        with torch.inference_mode():
            r["tp_offsets"] = motion_cnn.predict_offsets(
                single.model, torch.from_numpy(
                    inputs[preset]["windows"]).to(dev)).cpu().numpy()
        r["tp_frames"] = single.stabilize_clip(inputs[preset]["chunk"])
        r["tp_chunk_ms"] = 1e3 * wall_s(dev, lambda: single.stabilize_clip(
            inputs[preset]["chunk"]))[1]
    return refs


def p12_check(spec: MultiCard, n: int, refs: dict, ranks: list) -> tuple:
    """Phase 12's gates on every rank's results against one process.
    Returns (B1 launches, B2/B3 launches, the numbers, the gates missed);
    the caller logs the numbers, then raises on any miss."""
    b1, train_counts, results = 0, {k: 0 for k in train_launches()}, {}
    frames, fails = spec.clips * spec.clip_frames, []

    def hashes(name, got, want):
        try:
            same_hashes(name, got, want)
        except AssertionError as e:
            fails.append(str(e))

    for preset, _ in spec.presets:
        ref = refs[preset]
        one = ref["train"]
        res = results[preset] = {"ranks": n}
        for r, got in enumerate(ranks):
            g, where = got[preset], f"[{preset}] rank {r} of {n}"
            card = got["device"].startswith("cuda")
            # (a)
            for mode in ("plain", "causal", "lag"):
                for i, h in enumerate(g["sharded"][mode]["hashes"]):
                    hashes(f"{where}: sharded {mode} clip {i}", h,
                           ref[f"clips_{mode}"][i])
                b1 += g["sharded"][mode]["launches"]
            mine = list(range(r * spec.clips // n,
                              (r + 1) * spec.clips // n))
            for mode in ("plain", "causal"):
                m = g["sharded"][f"multi_{mode}"]
                if (sorted(m["hashes"]) != mine or not m["ok"]
                        or m["written"] != [spec.clip_frames] * spec.clips):
                    fails.append(
                        f"{where}: stabilize_multi(mesh=) {mode} wrote clips "
                        f"{sorted(m['hashes'])} (its own: {mine}), written "
                        f"{m['written']}, ok {m['ok']}")
                for i, h in m["hashes"].items():
                    hashes(f"{where}: stabilize_multi {mode} clip {i}", h,
                           ref[f"clips_{mode}"][i])
                b1 += m["launches"]
            # (b)
            for key, t in g["temporal"].items():
                hashes(f"{where}: temporal {key}", t["hashes"],
                       ref[f"long_{key}"]["hashes"])
                b1 += t["launches"]
            # (c)
            runs = g["dp"]
            for i, run in enumerate(runs):
                want = spec.steps if card else 0
                if any(v != want for v in run["launches"].values()):
                    fails.append(f"{where}: DP run {i} launched "
                                 f"{run['launches']} in {spec.steps} steps")
                for k, v in run["launches"].items():
                    train_counts[k] += v
            if (runs[1]["digest"] != runs[0]["digest"]
                    or runs[1]["losses"] != runs[0]["losses"]):
                fails.append(f"{where}: a second run of the same "
                             f"{spec.steps} DP steps differs from the first")
            if runs[0]["digest"] != ranks[0][preset]["dp"][0]["digest"]:
                fails.append(f"{where}: its DP parameters differ from rank "
                             "0's")
            loss_rel = [abs(a - b) / abs(b) for a, b in zip(
                runs[0]["losses"], one["losses"])]
            if max(loss_rel[:DP_GATED_STEPS]) > DP_LOSS_RTOL:
                fails.append(f"{where}: DP losses {loss_rel} relative from "
                             "train_step")
            # (d)
            for shape, t in g["tp"].items():
                if t["offsets_err"] > TP_TOL or t["lsb"] > 1 \
                        or t["launches"] != (1 if card else 0):
                    fails.append(f"{where}: TP {shape}: {t}")
                b1 += t["launches"]
            res[f"rank{r}"] = {
                "device": got["device"], "busy": g["sharded"].get("busy"),
                "sharded_s": {m: g["sharded"][m]["s"]
                              for m in ("plain", "causal", "lag")},
                "multi_s": {m: g["sharded"][f"multi_{m}"]["s"]
                            for m in ("plain", "causal")},
                "temporal": {k: {f: v for f, v in t.items()
                                 if f != "hashes"}
                             for k, t in g["temporal"].items()},
                "dp_loss_rel": loss_rel,
                "dp_steps_per_s": runs[0]["steps_per_s"],
                "tp": g["tp"]}
        # Rank 0 holds the arrays of its first DP run.
        got = ranks[0][preset]["dp"][0]
        param0 = max(float(np.abs(got["params0"][k] - v).max())
                     for k, v in one["params0"].items())
        grad_rel = max(float(np.abs(got["grads"][k] - v).max())
                       / max(float(np.abs(v).max()), 1e-30)
                       for k, v in one["grads"].items())
        if param0 > DP_PARAM_TOL or grad_rel > DP_GRAD_TOL:
            fails.append(f"[{preset}] DP over {n} ranks: the first step's "
                         f"parameters {param0:.2e}, gradients "
                         f"{grad_rel:.2e} from train_step")
        res.update(
            dp_param0_abs=param0, dp_grad_rel=grad_rel,
            dp_param_abs_after_steps=max(
                float(np.abs(got["params"][k] - v).max())
                for k, v in one["params"].items()),
            one_card={"sharded_fps": {m: frames / ref[f"one_card_{m}_s"]
                                      for m in ("plain", "causal", "lag")},
                      "temporal_chunk_ms": {
                          k[5:]: v["chunk_ms"] for k, v in ref.items()
                          if k.startswith("long_")},
                      "train_steps_per_s": one["steps_per_s"],
                      "tp_chunk_ms": ref["tp_chunk_ms"]},
            sharded_fps={m: frames / max(res[f"rank{r}"]["sharded_s"][m]
                                         for r in range(n))
                         for m in ("plain", "causal", "lag")},
            dp_steps_per_s=min(res[f"rank{r}"]["dp_steps_per_s"]
                               for r in range(n)))
    return b1, train_counts, results, fails


def p12_log(spec: MultiCard, n: int, results: dict) -> None:
    for preset, _ in spec.presets:
        res = results[preset]
        one = res["one_card"]
        ranks = [res[f"rank{r}"] for r in range(n)]
        log(f"  [{preset}] {n} {spec.backend} ranks on "
            + ", ".join(r["device"] for r in ranks) + ": every output == "
            "one process on one card bytewise; one B1 launch a (batched) "
            "chunk a rank, one B2 and one B3 pair a DP step a rank")
        log(f"  [{preset}] (a) ShardedClipStabilizer, {spec.clips} clips x "
            f"{spec.clip_frames} frames, frames/s end to end, {n} cards / "
            "one card: " + ", ".join(
                f"{m} {res['sharded_fps'][m]:.1f} / "
                f"{one['sharded_fps'][m]:.1f}"
                for m in ("plain", "causal", "lag"))
            + "; stabilize_multi(mesh=) s a rank: " + ", ".join(
                f"{m} " + " ".join(f"{r['multi_s'][m]:.3f}" for r in ranks)
                for m in ("plain", "causal"))
            + "; device idle share of a plain run: " + ", ".join(
                "not traced" if r["busy"] is None
                else f"{r['busy']['idle_pct']:.1f} %" for r in ranks))
        for key, ms in one["temporal_chunk_ms"].items():
            t = [r["temporal"][key] for r in ranks]
            log(f"  [{preset}] (b) temporal {key}: chunk ms end to end, "
                f"{n} ranks " + ", ".join(f"{x['chunk_ms']:.2f}" for x in t)
                + f" / one card {ms:.2f}; a chunk's ring_shift ms "
                + ", ".join(f"{x['ring_ms']:.3f}" for x in t)
                + ", all_gather ms "
                + ", ".join(f"{x['gather_ms']:.3f}" for x in t))
        rel = [max(r["dp_loss_rel"][i] for r in ranks)
               for i in range(spec.steps)]
        log(f"  [{preset}] (c) DP, batch {spec.batch} over {n} ranks, "
            f"{spec.steps} steps: losses relative to train_step, step by "
            f"step " + " ".join(f"{x:.1e}" for x in rel) + " (the first "
            f"{DP_GATED_STEPS} held), first step's parameters "
            f"{res['dp_param0_abs']:.2e} and gradients "
            f"{res['dp_grad_rel']:.2e} of the largest; parameters after "
            f"{spec.steps} steps {res['dp_param_abs_after_steps']:.2e} "
            "(recorded); a second run byte-equal, every rank equal; "
            f"steps/s {res['dp_steps_per_s']:.2f} vs train_step "
            f"{one['train_steps_per_s']:.2f} on one card")
        for shape in ranks[0]["tp"]:
            t = [r["tp"][shape] for r in ranks]
            log(f"  [{preset}] (d) TP {shape}: offsets within "
                f"{max(x['offsets_err'] for x in t):.2e} of one process, "
                f"chunk {max(x['lsb'] for x in t)} LSB "
                f"({max(x['share_off'] for x in t):.2e} of bytes off); "
                "chunk ms end to end " + ", ".join(
                    f"{x['chunk_ms']:.2f}" for x in t)
                + f" / one card {one['tp_chunk_ms']:.2f}; inside "
                f"gather_channels ({t[0]['gathers']} calls) ms "
                + ", ".join(f"{x['gather_ms']:.2f}" for x in t))


def multicard_run(spec: MultiCard, n: int, dev, work_dir: str,
                  seed: int) -> tuple:
    """(a)-(d) of phase 12 over ``n`` spawned ranks, each held against
    this one process on ``dev``. Returns (B1 launches, B2/B3 launches,
    results)."""
    import pickle
    from dvsg_tpu_torch.parallel.dryrun import run_ranks
    inputs = p12_inputs(spec, seed, dev)
    t0 = time.perf_counter()
    refs = p12_references(spec, inputs, dev)
    ref_s = time.perf_counter() - t0
    with open(os.path.join(work_dir, "p12_inputs.pkl"), "wb") as f:
        pickle.dump((inputs, {p: {k: refs[p][k] for k in ("tp_offsets",
                                                          "tp_frames")}
                              for p, _ in spec.presets}), f)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_ranks(_p12_rank, n, args=(n, os.path.join(work_dir, "p12_store"),
                                  work_dir, spec), timeout_s=900)
    ranks_s = time.perf_counter() - t0
    ranks = []
    for r in range(n):
        with open(os.path.join(work_dir, f"p12_rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    b1, train_counts, results, fails = p12_check(spec, n, refs, ranks)
    results.update(reference_s=ref_s, ranks_s=ranks_s)
    log(f"  one process's references {ref_s:.1f} s; {n} ranks spawned, run "
        f"and joined in {ranks_s:.1f} s")
    p12_log(spec, n, results)
    if fails:
        raise AssertionError("phase 12: " + "; ".join(fails))
    return b1, train_counts, results


def p12_entry_points(n: int, dev, work_dir: str, seed: int) -> dict:
    """(e) The user entry points on the cards: ``python -m
    dvsg_tpu_torch.parallel.dryrun n`` (NCCL, one rank a card) and, where
    OpenCV imports, the README's ``stabilize-batch`` under torchrun over
    seeded mp4s, byte-equal to the same command with ``--no-mesh``, each
    rank writing its own clips."""
    res = {}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "dvsg_tpu_torch.parallel.dryrun", str(n)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    want = (f"dryrun_multichip: {n} nccl ranks on "
            + ", ".join(f"cuda:{k}" for k in range(n)))
    if proc.returncode != 0 or want not in proc.stdout:
        raise AssertionError(f"dryrun {n}: exit {proc.returncode}, no "
                             f"{want!r}:\n{proc.stdout[-1500:]}\n"
                             f"{proc.stderr[-3000:]}")
    res["dryrun"] = {"s": time.perf_counter() - t0,
                     "line": next(x for x in proc.stdout.splitlines()
                                  if want in x)}
    log(f"  (e) dryrun {n} ({res['dryrun']['s']:.1f} s): "
        f"{res['dryrun']['line']}")
    if not have_opencv():
        log("  (e) stabilize-batch under torchrun: not run, OpenCV does not "
            "import here")
        res["stabilize_batch"] = "not run: no OpenCV"
        return res
    from dvsg_tpu_torch.utils import video_io
    ins = []
    for i in range(P12_MP4S):
        clip = make_clip(seed + 140 + i, P12_MP4_FRAMES, HEIGHT, WIDTH,
                         dev)[0]
        ins.append(os.path.join(work_dir, f"in{i}.mp4"))
        with video_io.VideoWriter(ins[-1], WIDTH, HEIGHT) as w:
            w.write_batch(clip)
    outs, runs = {}, {}
    for name, extra in (("mesh", ()), ("no_mesh", ("--no-mesh",))):
        outs[name] = [os.path.join(work_dir, f"{name}{i}")
                      for i in range(P12_MP4S)]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(n), "-m", "dvsg_tpu_torch",
             "stabilize-batch", "--inputs", *ins, "--outputs", *outs[name],
             "--preset", "fast", "--chunk-frames", str(T_CHUNK), *extra],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                filter(None, (ROOT, os.environ.get("PYTHONPATH"))))),
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"stabilize-batch under torchrun ({name}): "
                                 f"exit {proc.returncode}\n"
                                 f"{proc.stdout[-1500:]}\n"
                                 f"{proc.stderr[-3000:]}")
        runs[name] = {"s": time.perf_counter() - t0,
                      "stdout": proc.stdout.splitlines()[-12:],
                      "said": [x for x in proc.stdout.splitlines()
                               if x.startswith("stabilized ")],
                      "ranks": sorted(x for x in proc.stderr.splitlines()
                                      if x.startswith("rank "))}
    # Under the mesh each rank writes its own clip on its own card.
    per = P12_MP4S // n
    want = sorted(f"rank {r} of {n} on cuda:{r}: writes "
                  + ", ".join(outs["mesh"][r * per:(r + 1) * per])
                  for r in range(n))
    if runs["mesh"]["ranks"] != want:
        raise AssertionError(f"stabilize-batch under torchrun: the ranks "
                             f"said {runs['mesh']['ranks']}, not {want}")
    for a, b in zip(outs["mesh"], outs["no_mesh"]):
        fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
        if fa != fb or len(fa) != P12_MP4_FRAMES:
            raise AssertionError(f"{a}: {len(fa)} frames, {b}: {len(fb)}")
        for name in fa:
            with open(os.path.join(a, name), "rb") as x, \
                    open(os.path.join(b, name), "rb") as y:
                if x.read() != y.read():
                    raise AssertionError(f"{a}/{name} differs from the "
                                         "--no-mesh run's")
    res["stabilize_batch"] = runs
    log(f"  (e) stabilize-batch under torchrun, {P12_MP4S} seeded mp4s "
        f"({P12_MP4_FRAMES} frames, {WIDTH}x{HEIGHT}): each rank wrote its "
        f"own clip on its own card, every output byte-equal to --no-mesh; "
        f"{runs['mesh']['s']:.1f} s vs {runs['no_mesh']['s']:.1f} s "
        f"(--no-mesh), processes included; "
        + " / ".join(s for r in runs.values() for s in r["said"]))
    return res


def phase_multicard(seed: int, dev, work_dir: str) -> tuple:
    """Phase 12: one NCCL rank per card over 4 cards where there are four
    or more, else 2; nothing with one card. Returns (B1 launches, B2/B3
    launches, results)."""
    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"  phase 12 not run: cards: {cards} (one NCCL rank a card "
            "needs two or more)")
        return 0, {}, {"not run": f"cards: {cards}"}
    n = 4 if cards >= 4 else 2
    spec = MultiCard(tuple((p, os.path.join(ROOT, "checkpoints", c))
                           for p, c in PRESETS))
    b1, train_counts, results = multicard_run(spec, n, dev, work_dir, seed)
    results["entry_points"] = p12_entry_points(n, dev, work_dir, seed)
    return b1, train_counts, results


# --- the reference's argv and predict_grid -----------------------------------

# Phase 13: predict_grid's windows, its tolerance against the CPU path (the
# offsets tests' f32 atol, tests/test_torch_model.py), and the seeded mp4's
# frames for the repaired argv.
P13_WINDOWS = 2
P13_GRID_ATOL = 1e-4
P13_FRAMES = 48


def p13_predict_grid(seed: int, dev, height: int = HEIGHT,
                     width: int = WIDTH) -> dict:
    """(a) ``motion_cnn.predict_grid`` for both presets at full width, the
    grids at ``height`` x ``width``: bit-equal on ``dev`` to
    ``grid_from_offsets(predict_offsets(...))``, within ``P13_GRID_ATOL``
    of the CPU path."""
    cpu = torch.device("cpu")
    rng = np.random.default_rng(seed + 130)
    res = {}
    for preset, ckpt in PRESETS:
        params, mcfg = load_npz(os.path.join(ROOT, "checkpoints", ckpt))
        mh, mw = mcfg.model_size
        windows = torch.from_numpy(rng.uniform(
            -0.5, 0.5, (P13_WINDOWS, mh, mw, mcfg.window * mcfg.channels)
        ).astype(np.float32))
        with torch.inference_mode(), deterministic_cudnn():
            model = stab_lib.build_model(mcfg, params, dev)
            x = windows.to(dev)
            grid = motion_cnn.predict_grid(model, x, height, width)
            composed = grid_ops.grid_from_offsets(
                motion_cnn.predict_offsets(model, x), height, width)
            on_cpu = grid if dev == cpu else motion_cnn.predict_grid(
                stab_lib.build_model(mcfg, params, cpu), windows, height,
                width)
        err = float((grid.cpu() - on_cpu).abs().max())
        if tuple(grid.shape) != (P13_WINDOWS, height, width, 2):
            raise AssertionError(f"[{preset}] predict_grid shape "
                                 f"{tuple(grid.shape)}")
        if not torch.equal(grid, composed):
            raise AssertionError(f"[{preset}] predict_grid differs from "
                                 "grid_from_offsets(predict_offsets) on "
                                 f"{dev}")
        if not err <= P13_GRID_ATOL:
            raise AssertionError(f"[{preset}] predict_grid {err:.3g} from "
                                 "the CPU path")
        res[preset] = {"max_abs_vs_cpu": err}
        log(f"  [{preset}] predict_grid {P13_WINDOWS} windows {mh}x{mw} -> "
            f"{width}x{height} grids on {dev}: == grid_from_offsets("
            f"predict_offsets) bitwise, {err:.3g} from the CPU path")
    return res


def p13_argv(seed: int, dev, work_dir: str, height: int = HEIGHT,
             width: int = WIDTH, frames: int = P13_FRAMES) -> tuple:
    """(b) The argv the port used to refuse and the reference runs, through
    ``cli.main`` on a seeded mp4 (where OpenCV imports), B1's counts set to
    0 before each command and read after it: ``--checkpoint`` with
    ``--preset`` and ``--chunk-frames 0`` == ``--preset fast --chunk-frames
    16`` bytewise, one packed launch a chunk; ``eval --warp-impl auto
    --chunk-frames 0``; ``export --checkpoint --preset --warp-impl auto
    --for-platform``, then ``stabilize --artifact`` == the live run; ``eval
    --warp-impl pallas`` exits 2. Returns (B1 launches, results)."""
    from dvsg_tpu_torch import cli
    from dvsg_tpu_torch.utils import video_io
    if not have_opencv():
        log("  (b) not run: OpenCV does not import here")
        return 0, {"not run": "no OpenCV"}
    clip = make_clip(seed + 131, frames, height, width, dev)[0]
    mp4 = os.path.join(work_dir, "p13.mp4")
    with video_io.VideoWriter(mp4, width, height, fps=24.0) as w:
        w.write_batch(clip)
    fast = os.path.join(ROOT, "checkpoints", dict(PRESETS)["fast"])
    chunks = math.ceil(frames / T_CHUNK) if dev.type == "cuda" else 0
    launches, res = 0, {}

    def run(name, argv, rc=0, expect=None):
        nonlocal launches
        warp_wide.LAUNCHES = warp_wide.LAUNCHES_PACKED = 0
        t0 = time.perf_counter()
        got = cli.main(argv + ["--platform", dev.type])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        s = time.perf_counter() - t0
        n, packed = warp_wide.LAUNCHES, warp_wide.LAUNCHES_PACKED
        launches += n
        if got != rc:
            raise AssertionError(f"{name}: exit {got}, expected {rc}")
        if expect is not None and (n, packed) != (expect, expect):
            raise AssertionError(f"{name}: {n} launches ({packed} packed), "
                                 f"expected {expect}")
        res[name] = {"rc": got, "launches": n, "s": s}
        log(f"  {name}: exit {got}, {n} B1 launches ({packed} packed), "
            f"{s:.2f} s")

    def frames_of(name):
        with video_io.VideoReader(os.path.join(work_dir, name)) as r:
            return r.read_batch(frames + 1)

    io = lambda out: ["--input", mp4, "--output", os.path.join(work_dir, out)]
    run("stabilize --checkpoint fast --preset quality --chunk-frames 0",
        ["stabilize", *io("ck_preset"), "--checkpoint", fast, "--preset",
         "quality", "--chunk-frames", "0"], expect=chunks)
    run("stabilize --preset fast --chunk-frames 16",
        ["stabilize", *io("fast16"), "--preset", "fast", "--chunk-frames",
         str(T_CHUNK)], expect=chunks)
    live = frames_of("ck_preset")
    if len(live) != frames:
        raise AssertionError(f"stabilize wrote {len(live)} of {frames}")
    same_bytes("--checkpoint with --preset, --chunk-frames 0", [live],
               [frames_of("fast16")])
    run("eval --warp-impl auto --chunk-frames 0",
        ["eval", "--warp-impl", "auto", "--chunk-frames", "0", "--preset",
         "fast", "--clips", "1", "--frames", str(frames), "--size",
         str(height), str(width)])
    if dev.type == "cuda" and res["eval --warp-impl auto --chunk-frames 0"][
            "launches"] < 1:
        raise AssertionError("eval launched no B1")
    art = os.path.join(work_dir, "p13.dvsgt")
    run("export --checkpoint fast --preset quality --warp-impl auto "
        f"--for-platform {dev.type}",
        ["export", "--checkpoint", fast, "--preset", "quality",
         "--warp-impl", "auto", "--for-platform", dev.type, "--size",
         str(height), str(width), "--output", art], expect=0)
    run("stabilize --artifact", ["stabilize", "--artifact", art,
                                 *io("artifact")], expect=chunks)
    same_bytes("stabilize --artifact", [frames_of("artifact")], [live])
    run("eval --warp-impl pallas", ["eval", "--warp-impl", "pallas"], rc=2,
        expect=0)
    log(f"  (b) {frames}-frame {width}x{height} mp4: the repaired argv == "
        f"their counterparts bytewise; {launches} B1 launches")
    return launches, res


def phase_reference_argv(seed: int, dev, work_dir: str) -> tuple:
    """Phase 13: (a) ``predict_grid``; (b) the repaired argv on the card.
    Returns (B1 launches, results)."""
    t0 = time.perf_counter()
    res = {"predict_grid": p13_predict_grid(seed, dev)}
    launches, res["argv"] = p13_argv(seed, dev, work_dir)
    res["s"] = time.perf_counter() - t0
    log(f"  phase 13 took {res['s']:.1f} s")
    return launches, res


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
    ptxas = build_report()
    for line in ptxas:
        log("  " + line)

    log("== phase 2: kernels against their plain versions")
    rng = np.random.default_rng(args.seed)
    max_lsb = phase_kernel_checks(rng, dev)
    worst = phase_dense_kernel_checks(rng, dev)
    gelu_differ = phase_gelu_checks(rng, dev)

    log("== phase 3: stabilize path, both presets, 1280x720")
    launches, launches_dense, results, stabs, clip = phase_main_path(
        args.seed, dev)

    log("== phase 4: times of the stabilize path")
    b1 = phase_times(stabs, clip, dev, results)
    del stabs, clip

    log("== phase 5: path smoothing, auto-crop, online and overlap, both "
        "presets, 1280x720")
    smooth_launches, smooth_results = phase_smoothing(args.seed, dev)
    launches += smooth_launches

    log("== phase 6: training path at full width, then eval")
    with tempfile.TemporaryDirectory() as work_dir:
        train_results, train_counts, tuned = phase_training(args.seed,
                                                            work_dir)
        eval_results = phase_eval(args.seed, tuned)

    log("== phase 7: times of the training path and of each kernel")
    phase_train_times(args.seed, train_results)
    dense = time_dense_kernels(rng, dev)
    dense.update(time_gelu_kernels(dev))
    dense.update(time_gn_kernels(dev))

    log("== phase 8: batch and serve, both presets, 1280x720")
    with tempfile.TemporaryDirectory() as work_dir:
        batch_launches, batch_results = phase_batch(args.seed, dev, work_dir)
    launches += batch_launches

    log("== phase 9: parallel and export, both presets, 1280x720")
    with tempfile.TemporaryDirectory() as work_dir:
        p9_launches, p9_train, p9_results = phase_parallel_export(
            args.seed, dev, work_dir)
    launches += p9_launches
    for k, v in p9_train.items():
        train_counts[k] += v

    log("== phase 10: bf16 compute, the stacked arch and the profiler")
    with tempfile.TemporaryDirectory() as work_dir:
        p10_launches, p10_train, p10_results = phase_bf16_stacked(
            args.seed, dev, work_dir)
    launches += p10_launches
    for k, v in p10_train.items():
        train_counts[k] += v

    log("== phase 11: staging, export for the card without one, tensor "
        "parallelism, examples, quality table")
    with tempfile.TemporaryDirectory() as work_dir:
        p11_launches, p11_results = phase_last_modules(args.seed, dev,
                                                       work_dir)
    launches += p11_launches

    log("== phase 12: the multi-rank surfaces over NCCL, one rank a card")
    with tempfile.TemporaryDirectory() as work_dir:
        p12_launches, p12_train, p12_results = phase_multicard(
            args.seed, dev, work_dir)
    launches += p12_launches
    for k, v in p12_train.items():
        train_counts[k] += v

    log("== phase 13: the reference's argv and predict_grid")
    with tempfile.TemporaryDirectory() as work_dir:
        p13_launches, p13_results = phase_reference_argv(args.seed, dev,
                                                         work_dir)
    launches += p13_launches

    def entry(name, source, replaces, n_launches, err, rec,
              err_name="max_abs_err"):
        return {"name": name, "route": "cuda",
                "source": f"dvsg_tpu_torch/csrc/{source}.cu",
                "replaces": replaces, "launches": n_launches,
                err_name: err, "ms": rec["ms"],
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
        *(entry(name, "bf16_round", "none (XLA's fusion)",
                p10_results["gelu_launches"][name],
                gelu_differ + dense[name]["values_differ"], dense[name],
                err_name="values_differ")
          for name in ("gelu_bf16_fwd", "gelu_bf16_bwd")),
        entry("group_norm_bf16_fwd", "bf16_round", "none (XLA's fusion)",
              p10_results["gn_launches"]["group_norm_bf16_fwd"],
              dense["group_norm_bf16_fwd"]["against_chain"][
                  "out_ulps_at_scale"], dense["group_norm_bf16_fwd"],
              err_name="ulps_from_chain_at_scale"),
        entry("group_norm_bf16_bwd", "bf16_round", "none (XLA's fusion)",
              p10_results["gn_launches"]["group_norm_bf16_bwd"],
              dense["group_norm_bf16_bwd"]["against_chain"]["dx_off_f64"],
              dense["group_norm_bf16_bwd"],
              err_name="dx_values_off_f64_vs_chain"),
    ]
    if any(k["launches"] < 1 for k in kernels):
        raise AssertionError(f"a kernel was never launched on its path: "
                             f"{[(k['name'], k['launches']) for k in kernels]}")
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "seed": args.seed,
              "kernels": kernels, "b1": b1, "dense_kernels": dense,
              "presets": results, "smoothing": smooth_results,
              "training": train_results, "batch": batch_results,
              "parallel_export": p9_results,
              "bf16_stacked": p10_results, "last_modules": p11_results,
              "multicard": p12_results, "reference_argv": p13_results,
              "eval": eval_results, "build_s": build_s, "ptxas": ptxas,
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
