"""Streaming stabilization pipeline: one device step per T-frame chunk.

    uint8 chunk → resize to model res (normalize folded in) → encoder over
      the unique frames → feature windows → corr head offsets
      → fused offsets-to-warp-to-uint8 kernel → uint8 chunk

Long videos stream in chunks of T frames carrying a (window-1)-frame
model-resolution halo between chunks. The last partial chunk is padded
to T by replicating its final frame and trimmed on the host, so every
chunk has one shape.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from dvsg_tpu_torch import resolve_device
from dvsg_tpu_torch.config import StabilizeConfig
from dvsg_tpu_torch.models import motion_cnn
from dvsg_tpu_torch.ops import resize as resize_ops
from dvsg_tpu_torch.ops import warp as warp_ops
from dvsg_tpu_torch.utils.metrics import StageTimer


def normalize_frames(frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] → f32 [0, 1]."""
    return frames_u8.to(torch.float32) * (1.0 / 255.0)


def quantize_frames(frames: torch.Tensor) -> torch.Tensor:
    """f32 [0, 1] → uint8, round half to even."""
    return torch.clamp(torch.round(frames * 255.0), 0, 255).to(torch.uint8)


def predict_chunk_offsets(cfg: StabilizeConfig,
                          model: motion_cnn.MotionEstimator,
                          seq: torch.Tensor, t: int) -> torch.Tensor:
    """Coarse offsets (t, gh, gw, 2) for ``t`` output frames from the
    (t + window - 1)-frame model-resolution sequence (t+N-1, mh, mw, C).

    Sliding windows share window-1 frames, so each unique frame is encoded
    once and feature windows are assembled from the cache.
    """
    n = cfg.model.window
    feats = motion_cnn.encode_frames(model, seq)             # (t+n-1, ...)
    idx = (torch.arange(t, device=seq.device)[:, None]
           + torch.arange(n, device=seq.device)[None, :])
    offsets = motion_cnn.offsets_from_feature_windows(model, feats[idx])
    if cfg.strength != 1.0:
        # Partial stabilization: scale the predicted correction.
        offsets = offsets * cfg.strength
    return offsets


def stabilize_chunk_impl(cfg: StabilizeConfig,
                         model: motion_cnn.MotionEstimator,
                         frames_u8: torch.Tensor, halo: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """One device step over a T-frame chunk.

    Args:
      cfg: pipeline config.
      model: the motion CNN, on the chunk's device.
      frames_u8: (T, H, W, C) uint8 RGB chunk.
      halo: (window-1, mh, mw, C) f32 model-res history, centered at 0.

    Returns:
      (stabilized_u8 (T, H, W, C), new_halo, offsets (T, gh, gw, 2)).
    """
    t = frames_u8.shape[0]
    mh, mw = cfg.model.model_size
    small = resize_ops.downscale_norm(frames_u8, mh, mw)
    seq = torch.cat([halo, small], dim=0)        # (T+N-1, mh, mw, C)
    offsets = predict_chunk_offsets(cfg, model, seq, t)
    out_u8 = warp_ops.warp_quantize_batch(
        frames_u8, offsets=offsets, border_crop=cfg.border_crop)
    return out_u8, seq[t:], offsets


def put_frames(host_frames: np.ndarray, device) -> torch.Tensor:
    """Host → device upload of (..., H, W, C) uint8 frames."""
    # np.require copies only what torch cannot wrap (non-contiguous or
    # read-only arrays).
    t = torch.from_numpy(np.require(host_frames, requirements=["C", "W"]))
    return t.to(device)


def fetch_frames(dev_frames: torch.Tensor) -> np.ndarray:
    """Device → host fetch of (..., H, W, C) uint8 frames."""
    return dev_frames.cpu().numpy()


def initial_halo(cfg: StabilizeConfig, first_frame_u8: np.ndarray,
                 device) -> torch.Tensor:
    """Replicate-pad history for the start of a stream.

    The carried halo is pure input history: the downscaled last window-1
    raw frames, nothing else.
    """
    mh, mw = cfg.model.model_size
    f = put_frames(np.asarray(first_frame_u8, np.uint8)[None], device)
    small = resize_ops.downscale_norm(f, mh, mw)
    return small.repeat(cfg.model.window - 1, 1, 1, 1)


class Stabilizer:
    """User-facing stabilization engine: arrays in, arrays out.

    ``stabilize_clip`` handles a full in-memory clip; ``stabilize_stream``
    drives a reader → writer pair chunk by chunk. ``params`` is a state
    dict (utils/checkpoint.py); the model runs on ``device``.
    """

    def __init__(self, cfg: StabilizeConfig, params: dict,
                 device="cuda"):
        if cfg.path_smooth > 0 or cfg.path_smooth_lag > 0:
            raise NotImplementedError(
                "path smoothing (path_smooth, path_smooth_lag) is not "
                "ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        # The configs are float32: keep cuDNN convolutions and cuBLAS
        # matmuls in full f32 (TF32 keeps ~3 decimal digits, far outside
        # the reference's tolerance). These are process-wide switches.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.model = motion_cnn.MotionEstimator(cfg.model)
        self.model.load_state_dict(params)
        self.model.to(self.device).eval()
        self.chunks_seen = 0
        # A CUDA gather reads any in-range address, so no chunk ever falls
        # back to a slower path; kept for the reference's reporting surface.
        self.coverage_fallbacks = 0

    @torch.inference_mode()
    def _chunk(self, dev_chunk: torch.Tensor, halo: torch.Tensor):
        """One device step: the one dispatch point of every chunk loop."""
        self.chunks_seen += 1
        return stabilize_chunk_impl(self.cfg, self.model, dev_chunk, halo)

    @torch.inference_mode()
    def _initial_halo(self, first_frame_u8: np.ndarray) -> torch.Tensor:
        return initial_halo(self.cfg, first_frame_u8, self.device)

    def _pad(self, chunk: np.ndarray) -> np.ndarray:
        t_chunk = self.cfg.chunk_frames
        if chunk.shape[0] < t_chunk:         # pad to the static chunk shape
            pad = np.repeat(chunk[-1:], t_chunk - chunk.shape[0], axis=0)
            chunk = np.concatenate([chunk, pad], axis=0)
        return chunk

    def stabilize_clip(self, frames_u8: np.ndarray) -> np.ndarray:
        """frames_u8 (T, H, W, C) uint8 → stabilized (T, H, W, C) uint8."""
        total = frames_u8.shape[0]
        if total == 0:
            return frames_u8
        halo = self._initial_halo(frames_u8[0])
        t_chunk = self.cfg.chunk_frames
        outs = []
        for start in range(0, total, t_chunk):
            chunk = frames_u8[start:start + t_chunk]
            n_valid = chunk.shape[0]
            out, halo, _ = self._chunk(
                put_frames(self._pad(chunk), self.device), halo)
            outs.append(fetch_frames(out[:n_valid]))
        return np.concatenate(outs, axis=0)

    def stabilize_stream(self, reader, writer,
                         timer: Optional[StageTimer] = None,
                         resume_dir: Optional[str] = None) -> int:
        """Stream reader → writer; returns the number of frames written.

        ``reader`` needs ``read_batch(n)`` and ``skip(n)``, ``writer``
        ``write_batch(frames)`` and ``seek(i)`` (utils/video_io.py).

        ``resume_dir``: if given, one resume record (frames written + the
        streaming halo) is flushed atomically at every chunk boundary, and
        an interrupted job restarts from the last flushed chunk. Needs an
        appendable (frame-directory) output.

        The "compute" stage ends in a device synchronize, so it holds the
        chunk's device time.
        """
        timer = timer or StageTimer()
        t_chunk = self.cfg.chunk_frames
        halo = None
        written = 0
        state_path = None
        if resume_dir:
            os.makedirs(resume_dir, exist_ok=True)
            state_path = os.path.join(resume_dir, "resume_state.npz")
            if os.path.exists(state_path):
                with np.load(state_path) as z:
                    written = int(z["frames_written"])
                    halo_np = np.array(z["halo"])
                    unported = [k for k in ("smooth_state", "lag_offsets")
                                if k in z.files]
                if written > 0:
                    if unported:
                        raise ValueError(
                            "resume record was written by a path-smoothing "
                            "run, which is not ported yet; restart the job "
                            "(or point resume_dir elsewhere)")
                    skipped = reader.skip(written)
                    if skipped != written:
                        raise ValueError(
                            f"resume record says {written} frames but "
                            f"input only has {skipped} to skip")
                    writer.seek(written)
                    halo = torch.from_numpy(halo_np).to(self.device)
        while True:
            with timer.stage("decode"):
                chunk = reader.read_batch(t_chunk)
            n_valid = chunk.shape[0]
            if n_valid == 0:
                break
            if halo is None:
                halo = self._initial_halo(chunk[0])
            with timer.stage("h2d"):
                dev_chunk = put_frames(self._pad(chunk), self.device)
            with timer.stage("compute"):
                out, halo, _ = self._chunk(dev_chunk, halo)
                if out.is_cuda:
                    torch.cuda.synchronize(out.device)
            with timer.stage("d2h"):
                host_out = fetch_frames(out[:n_valid])
            with timer.stage("encode"):
                writer.write_batch(host_out)
            written += n_valid
            if state_path:
                tmp = os.path.join(resume_dir, "resume_state.tmp.npz")
                np.savez(tmp, halo=halo.cpu().numpy(),
                         frames_written=written)
                os.replace(tmp, state_path)    # atomic flush
            if n_valid < t_chunk:
                break
        return written
