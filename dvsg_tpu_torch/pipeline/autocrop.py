"""Two-pass auto border-crop: scan the predicted offsets, pick the smallest
zoom that keeps every warp sampling coordinate in the frame.

Pass 1 runs the resize and the CNN only (no warp), and the running max
stays on the device across chunks, so a whole clip costs one scalar fetch
at the end; several clips scan in lockstep through one batched step a
chunk and share the max (``scan_readers_max_offset``).

Crop math. The warp samples x = s·px + (1−s)/2·(W−1) + xoff_px with
s = 1 − 2·crop: the identity term keeps crop·(W−1) of margin at both edges,
so every coordinate stays inside [0, W−1] iff |xoff_px| ≤ crop·(W−1). With
xoff_px = off_x·(W−1)/2 that is crop ≥ |off_x|/2, whatever the resolution;
the same for y. The dense offset field is a bilinear (convex) upsample of
the control points, so their max bounds the dense max, and pass 2 predicts
the same offsets (same chunking, halo and strength), so rounding the crop
up is the only margin needed. The crop is rounded up to a multiple of 1/64,
as the JAX package does (there it bounds the programs compiled per crop).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from dvsg_tpu_torch import resolve_device
from dvsg_tpu_torch.config import StabilizeConfig
from dvsg_tpu_torch.models import motion_cnn
from dvsg_tpu_torch.pipeline.stabilize import (build_model,
                                               downscale_frames,
                                               initial_halo,
                                               predict_chunk_offsets,
                                               put_frames)

CROP_DENOM = 64          # crop quantization grid (see module docstring)
MAX_CROP_STEPS = CROP_DENOM // 2 - 1   # largest multiple < 0.5


def predict_scan_chunk_impl(cfg: StabilizeConfig,
                            model: motion_cnn.MotionEstimator,
                            frames_u8: torch.Tensor, halo: torch.Tensor,
                            running_max: torch.Tensor):
    """Predict-only device step: fold a chunk's max |offset| into the
    device-resident running max. Returns (new_max, new_halo)."""
    t = frames_u8.shape[0]
    seq = torch.cat([halo, downscale_frames(cfg, frames_u8)], dim=0)
    offsets = predict_chunk_offsets(cfg, model, seq, t)
    return torch.maximum(running_max, offsets.abs().amax()), seq[t:]


def _padded(chunk: np.ndarray, t_chunk: int) -> np.ndarray:
    if chunk.shape[0] < t_chunk:
        pad = np.repeat(chunk[-1:], t_chunk - chunk.shape[0], axis=0)
        chunk = np.concatenate([chunk, pad], axis=0)
    return chunk


@torch.inference_mode()
def scan_stream_max_offset(cfg: StabilizeConfig, params: dict, reader,
                           device="cuda") -> float:
    """Pass 1 over a reader: max |normalized offset| of the clip.

    Chunking, padding and halo carry are those of
    ``Stabilizer.stabilize_stream``, so pass 2 predicts the same offsets.
    The last partial chunk's replicate-padding frames count in the max
    (conservative: pass 2 computes them and trims them)."""
    dev = resolve_device(device)
    model = build_model(cfg.model, params, dev)
    t_chunk = cfg.chunk_frames
    halo = None
    m = torch.zeros((), dtype=torch.float32, device=dev)
    while True:
        chunk = reader.read_batch(t_chunk)
        n_valid = chunk.shape[0]
        if n_valid == 0:
            break
        if halo is None:
            halo = initial_halo(cfg, chunk[0], dev)
        m, halo = predict_scan_chunk_impl(
            cfg, model, put_frames(_padded(chunk, t_chunk), dev), halo, m)
        if n_valid < t_chunk:
            break
    return float(m)


@torch.inference_mode()
def scan_clip_max_offset(cfg: StabilizeConfig, params: dict,
                         frames_u8: np.ndarray, device="cuda") -> float:
    """Pass 1 over an in-memory (T, H, W, C) uint8 clip."""
    total = frames_u8.shape[0]
    if total == 0:
        return 0.0
    dev = resolve_device(device)
    model = build_model(cfg.model, params, dev)
    t_chunk = cfg.chunk_frames
    halo = initial_halo(cfg, frames_u8[0], dev)
    m = torch.zeros((), dtype=torch.float32, device=dev)
    for start in range(0, total, t_chunk):
        chunk = _padded(frames_u8[start:start + t_chunk], t_chunk)
        m, halo = predict_scan_chunk_impl(cfg, model, put_frames(chunk, dev),
                                          halo, m)
    return float(m)


def _scan_batch_impl(cfg: StabilizeConfig,
                     model: motion_cnn.MotionEstimator,
                     frames: torch.Tensor, halos: torch.Tensor,
                     active: torch.Tensor, running_max: torch.Tensor):
    """Predict-only step over a clip batch (the clip axis folded into the
    frame axis): fold each active clip's chunk max into the device-resident
    running max. ``active`` is a (B,) f32 mask; an exhausted clip repeats
    its last chunk with its contribution masked out (the maxima are
    non-negative). Returns (new_max, new_halos)."""
    t = frames.shape[1]
    seq = torch.cat([halos, downscale_frames(cfg, frames)], dim=1)
    offsets = predict_chunk_offsets(cfg, model, seq, t)
    m_b = offsets.abs().flatten(1).amax(dim=1)                 # (B,)
    return torch.maximum(running_max, (m_b * active).amax()), seq[:, t:]


@torch.inference_mode()
def scan_readers_max_offset(cfg: StabilizeConfig, params: dict, readers,
                            device="cuda") -> float:
    """Pass 1 over N same-resolution readers in lockstep, one batched step
    per chunk (as the batched pass 2 drives them), with one scalar fetch at
    the end. Equals the max of the per-clip scans: while a clip is active
    its chunks are those of its single-clip scan (the last one replicate-
    padded); after it ends its slot repeats its last chunk, masked out."""
    n = len(readers)
    if n == 0:
        return 0.0
    if n == 1:
        return scan_stream_max_offset(cfg, params, readers[0], device)
    dev = resolve_device(device)
    model = build_model(cfg.model, params, dev)
    t = cfg.chunk_frames
    m = torch.zeros((), dtype=torch.float32, device=dev)
    halos = None
    last = [None] * n
    exhausted = [False] * n
    while True:
        active = np.zeros((n,), np.float32)
        chunks = []
        for i, r in enumerate(readers):
            c = None
            if not exhausted[i]:
                c = r.read_batch(t)
                if c.shape[0] == 0:
                    exhausted[i], c = True, None
                else:
                    exhausted[i] = c.shape[0] < t  # after this padded step
                    c = last[i] = _padded(c, t)
                    active[i] = 1.0
            if c is None:
                if last[i] is None:             # a clip empty from the start
                    last[i] = np.zeros((t, r.height, r.width, 3), np.uint8)
                c = last[i]
            chunks.append(c)
        if not active.any():
            break
        batch = np.stack(chunks)
        if halos is None:
            halos = torch.stack([initial_halo(cfg, c[0], dev)
                                 for c in chunks])
        m, halos = _scan_batch_impl(cfg, model, put_frames(batch, dev),
                                    halos, torch.from_numpy(active).to(dev),
                                    m)
    return float(m)


def smoothing_margin(cfg: StabilizeConfig) -> float:
    """Extra |offset| the path-smoothing stage can add beyond what the
    predict-only scan sees: each component's correction is clamped to
    ±path_smooth_max, and the rotation and scale fields each add at most
    path_smooth_max per axis at the frame corners. Every auto-crop caller
    adds it to the scanned max."""
    if cfg.path_smooth <= 0:
        return 0.0
    terms = (1.0 + (1.0 if cfg.path_smooth_rotation else 0.0)
             + (1.0 if cfg.path_smooth_scale else 0.0))
    return cfg.path_smooth_max * terms


def crop_for_max_offset(max_abs_offset: float) -> Tuple[float, bool]:
    """Smallest multiple of 1/64 with crop ≥ max_abs_offset / 2, and
    whether it was capped: a clip so shaky that even the largest valid crop
    (31/64) cannot hide every border (the warp still clamps safely)."""
    needed = max(0.0, float(max_abs_offset)) * 0.5
    steps = math.ceil(needed * CROP_DENOM - 1e-9)
    if steps > MAX_CROP_STEPS:
        return MAX_CROP_STEPS / CROP_DENOM, True
    return steps / CROP_DENOM, False


def pick_border_crop(cfg: StabilizeConfig, params: dict, source,
                     device="cuda") -> Tuple[float, float, bool]:
    """One-call pass 1: scan ``source`` (a reader or a (T, H, W, C) uint8
    array) and return (border_crop, max_abs_offset, capped). With path
    smoothing on, ``smoothing_margin`` bounds the correction the scan does
    not compute."""
    if isinstance(source, np.ndarray):
        m = scan_clip_max_offset(cfg, params, source, device)
    else:
        m = scan_stream_max_offset(cfg, params, source, device)
    m += smoothing_margin(cfg)
    crop, capped = crop_for_max_offset(m)
    return crop, m, capped
