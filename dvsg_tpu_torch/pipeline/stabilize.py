"""Streaming stabilization pipeline: one device step per T-frame chunk.

    uint8 chunk → resize to model res (normalize folded in) → encoder over
      the unique frames → feature windows → corr head offsets (pwc: the
      pyramid's windows → PWC-Net's flows → head; the stacked arch:
      stacked pixel windows → the model) → fused
      offsets-to-warp-to-uint8 kernel → uint8 chunk

Long videos stream in chunks of T frames carrying a (window-1)-frame
model-resolution halo between chunks. The last partial chunk is padded
to T by replicating its final frame and trimmed on the host, so every
chunk has one shape. With ``cfg.path_smooth`` the chunk step also carries
the camera-path smoother's state (pipeline/pathsmooth.py), and with
``cfg.path_smooth_lag`` it emits its frames D frames late.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import numpy as np
import torch

from dvsg_tpu_torch import resolve_device
from dvsg_tpu_torch.config import StabilizeConfig
from dvsg_tpu_torch.models import motion_cnn
from dvsg_tpu_torch.ops import resize as resize_ops
from dvsg_tpu_torch.ops import warp as warp_ops
from dvsg_tpu_torch.ops.grouped import (CHUNK_GROUP, ENCODE_GROUP, each,
                                         in_groups)
from dvsg_tpu_torch.pipeline import pathsmooth
from dvsg_tpu_torch.utils.metrics import StageTimer


def normalize_frames(frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] → f32 [0, 1]."""
    return frames_u8.to(torch.float32) * (1.0 / 255.0)


def quantize_frames(frames: torch.Tensor) -> torch.Tensor:
    """f32 [0, 1] → uint8, round half to even."""
    return torch.clamp(torch.round(frames * 255.0), 0, 255).to(torch.uint8)


def downscale_frames(cfg: StabilizeConfig, frames_u8: torch.Tensor
                     ) -> torch.Tensor:
    """uint8 (..., T, H, W, C) → the model's f32 (..., T, mh, mw, C) input
    (``resize.downscale_norm``, in fixed-size calls on the card:
    ops/grouped.py)."""
    mh, mw = cfg.model.model_size
    flat = frames_u8.reshape(-1, *frames_u8.shape[-3:])
    small = in_groups(lambda f: resize_ops.downscale_norm(f, mh, mw), flat,
                      CHUNK_GROUP)
    return small.reshape(*frames_u8.shape[:-3], *small.shape[1:])


def build_windows(seq: torch.Tensor, num_out: int, window: int
                  ) -> torch.Tensor:
    """Stack sliding windows: seq (..., T+N-1, h, w, C) → (..., T, h, w,
    N*C); output t's window is seq[t : t+N], frame n's channel c at
    n*C + c."""
    idx = (torch.arange(num_out, device=seq.device)[:, None]
           + torch.arange(window, device=seq.device)[None, :])
    win = seq[..., idx, :, :, :]                  # (..., T, N, h, w, C)
    win = win.movedim(-4, -2)                     # (..., T, h, w, N, C)
    return win.reshape(*win.shape[:-2], -1)


def predict_chunk_offsets(cfg: StabilizeConfig,
                          model: motion_cnn.MotionEstimator,
                          seq: torch.Tensor, t: int) -> torch.Tensor:
    """Coarse offsets (..., t, gh, gw, 2) for ``t`` output frames from the
    (t + window - 1)-frame model-resolution sequence (..., t+N-1, mh, mw,
    C); a leading clip axis is folded into the frame axis.

    The corr and pwc archs encode each unique frame once (sliding windows
    share window-1 frames) and assemble feature windows from the cache
    (the pwc arch: one a pyramid level), per clip; the stacked arch runs
    the model on the stacked pixel windows. The model runs in fixed-size
    calls on the card (ops/grouped.py).
    """
    n = cfg.model.window
    lead = seq.shape[:-4]
    if cfg.model.arch == "stacked":
        windows = build_windows(seq, t, n)
        offsets = in_groups(
            lambda w: motion_cnn.predict_offsets(model, w),
            windows.reshape(-1, *windows.shape[-3:]), CHUNK_GROUP)
    else:
        feats = in_groups(lambda f: motion_cnn.encode_frames(model, f),
                          seq.reshape(-1, *seq.shape[-3:]), ENCODE_GROUP)
        idx = (torch.arange(t, device=seq.device)[:, None]
               + torch.arange(n, device=seq.device)[None, :])

        def windows(f):                         # (..., t, n, h, w, F) flat
            f = f.reshape(*lead, seq.shape[-4], *f.shape[1:])
            return f[..., idx, :, :, :].reshape(-1, n, *f.shape[-3:])
        offsets = in_groups(
            lambda w: motion_cnn.offsets_from_feature_windows(model, w),
            each(windows, feats), CHUNK_GROUP)
    offsets = offsets.reshape(*lead, t, *offsets.shape[1:])
    if cfg.strength != 1.0:
        # Partial stabilization: scale the predicted correction.
        offsets = offsets * cfg.strength
    return offsets


def _warp(cfg: StabilizeConfig, frames_u8: torch.Tensor,
          offsets: torch.Tensor) -> torch.Tensor:
    """The fused warp over every frame of (..., T, H, W, C): one launch of
    the offsets kernel, whatever the leading clip axes."""
    out = warp_ops.warp_quantize_batch(
        frames_u8.reshape(-1, *frames_u8.shape[-3:]),
        offsets=offsets.reshape(-1, *offsets.shape[-3:]),
        border_crop=cfg.border_crop)
    return out.reshape(frames_u8.shape)


def _chunk_body(cfg: StabilizeConfig, model: motion_cnn.MotionEstimator,
                frames_u8: torch.Tensor, halo: torch.Tensor,
                smooth_state: Optional[torch.Tensor]):
    """Shared body of the plain and the path-smoothed chunk steps, with or
    without a leading clip axis."""
    t = frames_u8.shape[-4]
    small = downscale_frames(cfg, frames_u8)
    seq = torch.cat([halo, small], dim=-4)       # (..., T+N-1, mh, mw, C)
    offsets = predict_chunk_offsets(cfg, model, seq, t)
    new_state = smooth_state
    if smooth_state is not None:
        # Cross-chunk camera-path smoothing (pipeline/pathsmooth.py): the
        # warp sees the final offsets.
        offsets, new_state = pathsmooth.apply_path_smoothing(
            cfg, seq, offsets, smooth_state)
    out_u8 = _warp(cfg, frames_u8, offsets)
    return out_u8, seq[..., t:, :, :, :], new_state, offsets


def stabilize_chunk_impl(cfg: StabilizeConfig,
                         model: motion_cnn.MotionEstimator,
                         frames_u8: torch.Tensor, halo: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """One device step over a T-frame chunk.

    Args:
      cfg: pipeline config.
      model: the motion CNN, on the chunk's device.
      frames_u8: (T, H, W, C) uint8 RGB chunk, or (B, T, H, W, C) for a
        batch of clips (parallel/dp.py).
      halo: (window-1, mh, mw, C) f32 model-res history, centered at 0
        (with the same leading clip axis).

    Returns:
      (stabilized_u8 (T, H, W, C), new_halo, offsets (T, gh, gw, 2)), each
      with the leading clip axis of the inputs.
    """
    out_u8, new_halo, _, offsets = _chunk_body(cfg, model, frames_u8, halo,
                                               None)
    return out_u8, new_halo, offsets


def stabilize_chunk_smooth_impl(cfg: StabilizeConfig,
                                model: motion_cnn.MotionEstimator,
                                frames_u8: torch.Tensor, halo: torch.Tensor,
                                smooth_state: torch.Tensor):
    """Path-smoothed device step (cfg.path_smooth > 0): the contract of
    ``stabilize_chunk_impl`` plus a carried (4,) f32 smoothing state ((B, 4)
    for a batch of clips). Returns (stabilized_u8, new_halo,
    new_smooth_state, offsets), the offsets being the applied (smoothed)
    ones."""
    return _chunk_body(cfg, model, frames_u8, halo, smooth_state)


def stabilize_chunk_lag_impl(cfg: StabilizeConfig,
                             model: motion_cnn.MotionEstimator,
                             frames_u8: torch.Tensor, halo: torch.Tensor,
                             carry_frames: torch.Tensor,
                             carry_offsets: torch.Tensor,
                             carry_d: torch.Tensor, carry_c: torch.Tensor):
    """Fixed-lag smoothed device step (cfg.path_smooth_lag = D > 0).

    Consumes input frames [kT, (k+1)T) and emits output frames
    [kT−D, (k+1)T−D): the last D input frames of a chunk are warped one
    chunk later, once their D-frame lookahead exists, through the
    zero-phase FIR smoother (pathsmooth.lag_corrections). Carried between
    chunks: the model-res halo, the D delayed raw frames, their D offset
    grids, and the trailing measurement window (deltas + confidence).
    Returns (emitted_u8 (T, H, W, C), new_halo, new_carry_frames,
    new_carry_offsets, new_carry_d, new_carry_c, emitted_offsets); inputs
    and outputs may carry a leading clip axis.

    The caller drops the first D emitted frames of a stream and feeds
    replicate-pad chunks after the end until the tail drains; a pad
    transition measures as an exact zero delta.
    """
    d_lag = cfg.path_smooth_lag
    t = frames_u8.shape[-4]
    small = downscale_frames(cfg, frames_u8)
    seq = torch.cat([halo, small], dim=-4)
    offsets_cur = predict_chunk_offsets(cfg, model, seq, t)

    deltas_cur, conf_cur = pathsmooth.measure(cfg, seq)
    deltas_ext = torch.cat([carry_d, deltas_cur], dim=-2)
    conf_ext = torch.cat([carry_c, conf_cur], dim=-1)
    e = pathsmooth.lag_corrections(cfg, deltas_ext, conf_ext, t)

    emit_frames = torch.cat(
        [carry_frames, frames_u8[..., :t - d_lag, :, :, :]], dim=-4)
    emit_offsets = torch.cat([carry_offsets,
                              offsets_cur[..., :t - d_lag, :, :, :]], dim=-4)
    emit_offsets = pathsmooth.apply_corrections(cfg, emit_offsets, e)
    out_u8 = _warp(cfg, emit_frames, emit_offsets)

    c_len = carry_d.shape[-2]
    return (out_u8, seq[..., t:, :, :, :],
            frames_u8[..., t - d_lag:, :, :, :],
            offsets_cur[..., t - d_lag:, :, :, :],
            deltas_ext[..., t:t + c_len, :], conf_ext[..., t:t + c_len],
            emit_offsets)


_LAG_KEYS = ("lag_offsets", "lag_d", "lag_c")     # resume-record keys


class ChunkStep:
    """The chunk step of ``cfg``'s smoothing mode, holding its own carry.

    ``step(frames_u8, halo)`` → (emitted u8 frames, new halo, offsets),
    frames (T, H, W, C) or, with ``batched``, (B, T, H, W, C), the halo
    with the same leading clip axis. Between calls the step keeps
    ``carry``: nothing in plain mode, the (…, 4) EMA state with
    ``cfg.path_smooth``, and with ``cfg.path_smooth_lag`` = D the D
    delayed raw frames, their offset grids and the measurement window
    (``stabilize_chunk_lag_impl``): a lag step emits the frames it is
    given ``shift`` = D frames late. A carry of None is made fresh at the
    next call (``fresh_carry``); a caller may hand one in (a serving
    segment's states, or ``restore`` from a resume record) and read the
    final one back.

    ``program`` is the pure step ``(frames, halo, *carry) → (out,
    new_halo, *new_carry, offsets)`` to wrap (an exported artifact's,
    export.py); by default the mode's ``_impl`` step on ``model``.
    """

    def __init__(self, cfg: StabilizeConfig,
                 model: Optional[motion_cnn.MotionEstimator] = None, *,
                 batched: bool = False, carry: Optional[tuple] = None,
                 program=None, device=None):
        self.cfg = cfg
        self.shift = cfg.path_smooth_lag
        self.batched = batched
        self.carry = carry
        if program is None:
            impl = (stabilize_chunk_lag_impl if self.shift
                    else stabilize_chunk_smooth_impl if cfg.path_smooth > 0
                    else stabilize_chunk_impl)
            program = functools.partial(impl, cfg, model)
        self.program = program
        self.device = _model_device(model) if device is None else device

    def __call__(self, frames_u8: torch.Tensor, halo: torch.Tensor):
        if self.batched and (frames_u8.dim() != 5 or halo.dim() != 5
                             or frames_u8.shape[0] != halo.shape[0]):
            raise ValueError(
                f"need (B, T, H, W, C) frames and (B, window-1, mh, mw, C) "
                f"halos, got {tuple(frames_u8.shape)} and "
                f"{tuple(halo.shape)}")
        if self.carry is None:
            self.carry = self.fresh_carry(frames_u8)
        out, new_halo, *carry, offsets = self.program(frames_u8, halo,
                                                      *self.carry)
        self.carry = tuple(carry)
        return out, new_halo, offsets

    def fresh_carry(self, frames_u8: torch.Tensor) -> tuple:
        """The carry at the start of a stream whose first chunk is
        ``frames_u8``: a zero EMA state, or for the lag mode the first
        frame D times (its emissions are dropped), zero offsets and a
        zero-delta measurement window with a huge confidence ('healthy, no
        motion', as the replicate-pad halo)."""
        cfg, lead, dev = self.cfg, frames_u8.shape[:-4], frames_u8.device
        if self.shift:
            gh, gw = cfg.model.grid_size
            c_len = pathsmooth.lag_carry_len(cfg)
            return (frames_u8[..., :1, :, :, :].repeat(
                        *(1,) * len(lead), self.shift, 1, 1, 1),
                    torch.zeros(lead + (self.shift, gh, gw, 2), device=dev),
                    torch.zeros(lead + (c_len, pathsmooth.STATE_DIM),
                                device=dev),
                    torch.full(lead + (c_len,), 1e6, device=dev))
        if cfg.path_smooth > 0:
            return (torch.zeros(lead + (pathsmooth.STATE_DIM,),
                                dtype=torch.float32, device=dev),)
        return ()

    def check_record(self, rec: dict) -> None:
        """Refuse a resume record written under another smoothing mode."""
        if self.shift:
            if "lag_offsets" not in rec:
                raise ValueError(
                    "resume record was written without the lag smoother's "
                    "carries but cfg.path_smooth_lag > 0; restart the job "
                    "(or point --resume-dir elsewhere)")
            return
        smooth = rec.get("smooth_state")
        if "lag_offsets" in rec:
            # A lag record resumed without the lag would shift every later
            # frame by D.
            raise ValueError(
                "resume record was written by a --path-smooth-lag run but "
                "cfg.path_smooth_lag == 0; resume with the original lag "
                "setting")
        if self.cfg.path_smooth > 0 and smooth is None:
            # Resuming would jump the camera path at the resume point.
            raise ValueError(
                "resume record was written without path smoothing but "
                "cfg.path_smooth > 0; restart the job (or point "
                "--resume-dir elsewhere)")
        if self.cfg.path_smooth == 0 and smooth is not None:
            # Dropping the state would switch the output from smoothed to
            # unsmoothed mid-stream.
            raise ValueError(
                "resume record carries a path-smoothing state but "
                "cfg.path_smooth == 0; resume with the original "
                "--path-smooth setting (or restart the job elsewhere)")

    def record(self) -> dict:
        """The carry as resume-record arrays, under the JAX package's keys;
        the lag mode's delayed frames are left out (a resume reads them
        again from the input)."""
        if self.shift:
            return {k: v.cpu().numpy()
                    for k, v in zip(_LAG_KEYS, self.carry[1:])}
        return ({"smooth_state": self.carry[0].cpu().numpy()} if self.carry
                else {})

    def restore(self, rec: Optional[dict] = None,
                frames: Optional[torch.Tensor] = None) -> None:
        """Start from a fresh carry, or from resume record ``rec``'s (the
        lag mode takes its D delayed frames, (D, H, W, C) uint8 on the
        step's device, beside it). A (2,) or (3,) state of an older record
        is zero-padded: the missing components start as a fresh EMA."""
        if rec is None:
            self.carry = None
        elif self.shift:
            self.carry = (frames, *(torch.from_numpy(rec[k]).to(self.device)
                                    for k in _LAG_KEYS))
        elif self.cfg.path_smooth > 0:
            s = np.asarray(rec["smooth_state"], np.float32).reshape(-1)
            s = np.concatenate([s, np.zeros(pathsmooth.STATE_DIM - len(s),
                                            np.float32)])
            self.carry = (torch.from_numpy(s).to(self.device),)
        else:
            self.carry = ()


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


def exact_math() -> None:
    """Keep cuDNN and cuBLAS in the precision the model asks for: no TF32
    for f32 (it keeps ~3 decimal digits, far outside the reference's
    tolerance) and no reduced-precision reductions for bf16 GEMMs. These
    are process-wide switches."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def build_model(mcfg, params: dict, device: torch.device
                ) -> motion_cnn.MotionEstimator:
    """The motion CNN with ``params`` loaded, on ``device``, for inference
    (``exact_math``)."""
    exact_math()
    model = motion_cnn.MotionEstimator(mcfg)
    model.load_state_dict(params)
    return model.to(device).eval()


class BehindFetch:
    """Device → host copies of chunk outputs that run behind the next
    chunk's compute (the clip-batch drivers' one-chunk-behind fetch).

    ``start(out)`` right after a chunk is dispatched queues the copy of
    ``out`` on a side stream once the chunk is done, into pinned memory;
    ``finish(handle)`` after the next chunk is dispatched waits for that
    copy alone. On the CPU both are plain copies.
    """

    def __init__(self, device: torch.device):
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def start(self, out: torch.Tensor):
        if self.stream is None:
            return out
        ready = torch.cuda.current_stream(out.device).record_event()
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(ready)
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            out.record_stream(self.stream)
            done = self.stream.record_event()
        return host, done

    def finish(self, handle) -> np.ndarray:
        if self.stream is None:
            return fetch_frames(handle)
        host, done = handle
        done.synchronize()
        return host.numpy()


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


@torch.inference_mode()
def drive_chunked_batch(step: ChunkStep, clips_u8: np.ndarray,
                        fetch_clips: Optional[int] = None,
                        initial_halos=None, return_halos: bool = False):
    """Drive a batched ``ChunkStep`` over an in-memory clip batch.

    The chunk/pad/dispatch/fetch loop shared by the clip-batch surfaces
    (pipeline/batching.py, parallel/dp.py, export.py). Emission is shifted
    by the step's ``shift`` D (0 outside the lag mode), so the loop runs D
    frames past the input, each clip padded by replicating its own last
    frame (by index clipping), and trims the emitted stream to [0, total).
    Chunk k+1 is dispatched before chunk k is fetched (``BehindFetch``),
    and only the first ``fetch_clips`` clips are fetched: pow2 padding
    clips are computed, never copied to the host.

    ``initial_halos`` ((B, window-1, mh, mw, C) f32) seeds the input
    history instead of the replicate-pad start (a mid-stream carry, with
    the step's carry handed in; the caller then feeds chunk-aligned
    segments), and ``return_halos`` also returns the final (B, ...) halos:
    ``(out, final_halos)``; the step's final carry is ``step.carry``.

    clips_u8 (B, T_total, H, W, C) uint8 → (fetch_clips, T_total, ...).
    """
    dev, t_chunk, d_lag = step.device, step.cfg.chunk_frames, step.shift
    b, total = clips_u8.shape[:2]
    k = b if fetch_clips is None else fetch_clips
    if initial_halos is not None:
        halos = torch.as_tensor(np.asarray(initial_halos, np.float32)
                                ).to(dev)
    else:
        halos = torch.stack([initial_halo(step.cfg, clips_u8[i, 0], dev)
                             for i in range(b)])
    fetch = BehindFetch(dev)
    outs, pending = [], None
    for start in range(0, total + d_lag, t_chunk):
        idx = np.clip(np.arange(start, start + t_chunk), 0, total - 1)
        out, halos, _ = step(put_frames(clips_u8[:, idx], dev), halos)
        if pending is not None:
            outs.append(fetch.finish(pending))
        pending = fetch.start(out[:k, max(0, d_lag - start):
                                  min(t_chunk, total + d_lag - start)])
    outs.append(fetch.finish(pending))
    result = np.concatenate([o for o in outs if o.shape[1]], axis=1)
    if return_halos:
        return result, halos
    return result


def _load_record(path: str) -> Optional[dict]:
    """The resume record at ``path`` as numpy arrays, or None."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: np.array(z[k]) for k in z.files}


def _save_record(resume_dir: str, **arrays) -> None:
    """Write the resume record atomically (one file: halo, frames written
    and the smoothing carries together, so no piece is a chunk newer than
    the rest)."""
    tmp = os.path.join(resume_dir, "resume_state.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(resume_dir, "resume_state.npz"))


class Stabilizer:
    """User-facing stabilization engine: arrays in, arrays out.

    ``stabilize_clip`` handles a full in-memory clip; ``stabilize_stream``
    drives a reader → writer pair chunk by chunk. ``params`` is a state
    dict (utils/checkpoint.py); the model runs on ``device``.
    """

    def __init__(self, cfg: StabilizeConfig, params: dict,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg.model, params, self.device)
        self.chunks_seen = 0
        # A CUDA gather reads any in-range address, so no chunk ever falls
        # back to a slower path; kept for the reference's reporting surface.
        self.coverage_fallbacks = 0
        # Every loop calls _chunk strictly in chunk order, so the step can
        # hold the stream's smoothing carry.
        self.step = ChunkStep(cfg, self.model, device=self.device)

    def begin_stream(self, rec: Optional[dict] = None,
                     frames: Optional[torch.Tensor] = None) -> None:
        """Reset per-stream state, or restore a resumed stream's smoothing
        carry from its record (``ChunkStep.restore``)."""
        self.step.restore(rec, frames)

    @torch.inference_mode()
    def _chunk(self, dev_chunk: torch.Tensor, halo: torch.Tensor):
        """One device step: the one dispatch point of every chunk loop
        (clip, stream, overlapped stream, online push)."""
        self.chunks_seen += 1
        return self.step(dev_chunk, halo)

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
        """frames_u8 (T, H, W, C) uint8 → stabilized (T, H, W, C) uint8.

        Emission is shifted by D = cfg.path_smooth_lag frames, so the loop
        runs D frames past the input (replicate pad) and trims the emitted
        stream to [0, total)."""
        total = frames_u8.shape[0]
        if total == 0:
            return frames_u8
        d_lag, t_chunk = self.cfg.path_smooth_lag, self.cfg.chunk_frames
        self.begin_stream()
        halo = self._initial_halo(frames_u8[0])
        outs = []
        for start in range(0, total + d_lag, t_chunk):
            idx = np.clip(np.arange(start, start + t_chunk), 0, total - 1)
            out, halo, _ = self._chunk(
                put_frames(frames_u8[idx], self.device), halo)
            lo = max(0, d_lag - start)
            hi = min(t_chunk, total + d_lag - start)
            if hi > lo:
                outs.append(fetch_frames(out[lo:hi]))
        return np.concatenate(outs, axis=0)

    def _sync(self, out: torch.Tensor) -> None:
        if out.is_cuda:
            torch.cuda.synchronize(out.device)

    def _resume(self, rec: dict, reader, writer):
        """Restore a stream from its record: refuse a record of another
        smoothing mode, skip the frames written, seek the writer, restore
        the carries. Returns (frames written, halo, the last input frame
        read, the stream's length if known).

        A lag record's ``lag_real`` says how many of the D carried raw
        frames are real input (< D only when it was written in the
        end-of-stream drain region); they are read again from the input.
        """
        d_lag = self.cfg.path_smooth_lag
        written = int(rec["frames_written"])
        self.step.check_record(rec)
        lag_real = int(rec["lag_real"]) if d_lag else 0
        if d_lag and lag_real == 0:
            return written, None, None, written     # job already complete
        skipped = reader.skip(written)
        if skipped != written:
            raise ValueError(f"resume record says {written} frames but "
                             f"input only has {skipped} to skip")
        frames = last_host = None
        if d_lag:
            cf = reader.read_batch(lag_real)
            if cf.shape[0] != lag_real:
                raise ValueError(
                    f"resume record expects {lag_real} carry frames after "
                    f"frame {written}; input yielded {cf.shape[0]} — did "
                    "the input change?")
            if lag_real < d_lag:
                cf = np.concatenate(
                    [cf, np.repeat(cf[-1:], d_lag - lag_real, axis=0)])
            frames, last_host = put_frames(cf, self.device), cf[-1:]
        writer.seek(written)
        self.begin_stream(rec, frames)
        # Written in the drain region: the stream's end is known.
        total = written + lag_real if lag_real < d_lag else None
        return (written, torch.from_numpy(rec["halo"]).to(self.device),
                last_host, total)

    def stabilize_stream(self, reader, writer,
                         timer: Optional[StageTimer] = None,
                         resume_dir: Optional[str] = None) -> int:
        """Stream reader → writer; returns the number of frames written.

        ``reader`` needs ``read_batch(n)`` and ``skip(n)``, ``writer``
        ``write_batch(frames)`` and ``seek(i)`` (utils/video_io.py). The
        overlapped stream is pipeline/overlap.py.

        Emission is shifted by D = cfg.path_smooth_lag frames: after every
        chunk the input position is the emission base + D, the frames
        flushed are max(0, base), and past the input's end the loop feeds
        replicate-pad chunks until the tail drains.

        ``resume_dir``: if given, one resume record (frames written, the
        streaming halo and the smoothing carries, under the JAX package's
        keys, so a record of either package resumes in the other) is
        flushed atomically at every chunk boundary, and an interrupted job
        restarts from the last flushed chunk. Needs an appendable
        (frame-directory) output.

        The "compute" stage ends in a device synchronize, so it holds the
        chunk's device time.
        """
        timer = timer or StageTimer()
        d_lag, t_chunk = self.cfg.path_smooth_lag, self.cfg.chunk_frames
        written = 0
        halo = last_host = total = None
        base = -d_lag           # global index of the next chunk's out[0]
        self.begin_stream()
        if resume_dir:
            os.makedirs(resume_dir, exist_ok=True)
            rec = _load_record(os.path.join(resume_dir, "resume_state.npz"))
            if rec is not None and int(rec["frames_written"]) > 0:
                written, halo, last_host, total = self._resume(rec, reader,
                                                               writer)
                base = written
        while total is None or base < total:
            n_in = 0
            if total is None:
                with timer.stage("decode"):
                    chunk = reader.read_batch(t_chunk)
                n_in = chunk.shape[0]
            if n_in:
                last_host = chunk[-1:]
                if halo is None:
                    halo = self._initial_halo(chunk[0])
            if n_in < t_chunk:
                if total is None:
                    total = base + d_lag + n_in     # input position + n_in
                if last_host is None or base >= total:
                    break                           # empty or drained
                pad = np.repeat(last_host, t_chunk - n_in, axis=0)
                chunk = np.concatenate([chunk, pad]) if n_in else pad
            with timer.stage("h2d"):
                dev_chunk = put_frames(chunk, self.device)
            with timer.stage("compute"):
                out, halo, _ = self._chunk(dev_chunk, halo)
                self._sync(out)
            lo = max(0, -base)
            hi = t_chunk if total is None else min(t_chunk, total - base)
            if hi > lo:
                with timer.stage("d2h"):
                    host_out = fetch_frames(out[lo:hi])
                with timer.stage("encode"):
                    writer.write_batch(host_out)
                written += hi - lo
            base += t_chunk
            if resume_dir and written > 0:
                real = ({"lag_real": d_lag if total is None
                         else max(0, min(d_lag, total - base))}
                        if d_lag else {})
                _save_record(resume_dir, halo=halo.cpu().numpy(),
                             frames_written=written, **self.step.record(),
                             **real)
        return written
