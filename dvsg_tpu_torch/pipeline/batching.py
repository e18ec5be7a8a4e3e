"""Request batching for the serving surface.

``BatchStabilizer`` lets concurrent callers share the card: request
threads submit in-memory clips and block; one device worker thread groups
whatever arrived within a small window (plus everything already queued)
into one batched chunk step per chunk (pipeline/stabilize.py's
``ChunkStep``: the clip axis folded into the frame axis, one launch of the offsets kernel over every
frame of the group) and hands each caller its clip back.

Groups are padded to the next power of two with copies of their first
clip, so a worker meets at most log2(max_batch) + 1 batch shapes per
resolution; mixed resolutions split into one group each. Clips inside a
group may differ in length: shorter ones are padded to the longest by
replicating their last frame and trimmed on the way out, as the offline
driver does.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from dvsg_tpu_torch import resolve_device
from dvsg_tpu_torch.config import StabilizeConfig
from dvsg_tpu_torch.pipeline import pathsmooth
from dvsg_tpu_torch.pipeline.autocrop import CROP_DENOM
from dvsg_tpu_torch.pipeline.stabilize import (ChunkStep, build_model,
                                               drive_chunked_batch,
                                               initial_halo)


@dataclass
class _Request:
    frames: np.ndarray                    # (T, H, W, C) uint8
    crop: Optional[float] = None          # per-request border_crop override
    halo_in: Optional[np.ndarray] = None  # mid-stream carry: input history
    smooth_state: Optional[np.ndarray] = None   # (4,) incoming EMA state
    return_state: bool = False
    done: threading.Event = field(default_factory=threading.Event)
    output: Optional[np.ndarray] = None
    out_carry: Optional[tuple] = None     # (halo, state) after last chunk
    error: Optional[Exception] = None


class BatchStabilizer:
    """Thread-safe clip stabilizer that batches concurrent callers onto one
    device step per chunk.

    ``stabilize_clip`` blocks the calling thread until its clip is done;
    concurrency comes from many threads calling it at once. ``window_s`` is
    how long the device worker waits for co-travellers after the first
    request of a group arrives. ``params`` is a state dict; the model runs
    on ``device``.
    """

    def __init__(self, cfg: StabilizeConfig, params: dict,
                 max_batch: int = 8, window_s: float = 0.005,
                 device="cuda"):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # The worker thread selects this card by its index.
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.model = build_model(cfg.model, params, self.device)
        self.max_batch = max(1, max_batch)
        self.window_s = window_s
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        # coverage_fallback_chunks stays 0: the CUDA gather has no coverage
        # band (kept for the reference's /healthz surface).
        self.stats = {"requests": 0, "batches": 0, "max_group": 0,
                      "coverage_fallback_chunks": 0}
        self._closed = False
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- public API -----------------------------------------------------

    def stabilize_clip(self, frames_u8: np.ndarray,
                       border_crop: Optional[float] = None,
                       carry=None, return_carry: bool = False):
        """(T, H, W, C) uint8 → stabilized same shape; thread-safe.

        ``border_crop`` overrides the engine config's crop for this request
        (serve's ``--border-crop auto``); requests group by (resolution,
        crop), so same-crop co-travellers still share a step. Values must
        lie on the auto-crop grid (multiples of 1/64), which bounds the
        number of groups; one equal to the engine's own crop is the
        engine's default.

        ``carry`` / ``return_carry`` (path smoothing only): a mid-stream
        carry ``(halo (window-1, mh, mw, C) f32, smooth_state (4,) f32)``
        for callers that thread one stream through several segments
        (serve's bounded-memory uploads). With ``return_carry=True`` the
        call returns ``(output, (halo, state))`` taken after this clip's
        last chunk. Carry requests also group by clip length, so padding a
        group to its longest clip never moves a carry past the true stream
        position; every non-final segment must be a multiple of
        cfg.chunk_frames for the same reason.
        """
        frames_u8 = np.asarray(frames_u8)
        if frames_u8.ndim != 4 or frames_u8.shape[0] == 0:
            raise ValueError(f"need a (T, H, W, C) clip, "
                             f"got {frames_u8.shape}")
        if frames_u8.dtype != np.uint8:
            # Refuse rather than cast: float frames in [0, 1] would
            # truncate to near-black.
            raise TypeError(f"need uint8 frames in [0, 255], got "
                            f"{frames_u8.dtype}")
        if border_crop is not None:
            if not 0.0 <= border_crop < 0.5:
                raise ValueError(f"border_crop must be in [0, 0.5), "
                                 f"got {border_crop}")
            if border_crop == self.cfg.border_crop:
                # The engine's own crop, on the grid or not.
                border_crop = None
            else:
                steps = border_crop * CROP_DENOM
                if abs(steps - round(steps)) > 1e-9:
                    raise ValueError(
                        f"border_crop must be a multiple of 1/{CROP_DENOM} "
                        f"(the auto-crop grid), got {border_crop}")
        if (carry is not None or return_carry) and self.cfg.path_smooth <= 0:
            raise ValueError("carry/return_carry are the path-smoothing "
                             "segment-threading API; cfg.path_smooth is 0")
        if (carry is not None or return_carry) \
                and self.cfg.path_smooth_lag > 0:
            # The lag carries hold D raw full-resolution frames; serve caps
            # lag uploads at one segment instead.
            raise ValueError(
                "segment carries are not supported with path_smooth_lag; "
                "submit whole clips (or use the causal smoother for "
                "segmented streams)")
        if return_carry and frames_u8.shape[0] % self.cfg.chunk_frames:
            raise ValueError(
                "a segment that returns a carry (i.e. any non-final "
                "segment) must be a multiple of chunk_frames="
                f"{self.cfg.chunk_frames}: tail padding would advance the "
                f"carry past the true stream position; got "
                f"{frames_u8.shape[0]} frames")
        halo_in = smooth_state = None
        if carry is not None:
            halo_in, smooth_state = carry
            halo_in = np.asarray(halo_in, np.float32)
            smooth_state = np.asarray(smooth_state, np.float32)
            want = pathsmooth.STATE_DIM
            if smooth_state.shape != (want,):
                raise ValueError(
                    f"carry smooth_state must be a ({want},) f32 vector "
                    f"(x, y, θ, log-s), got shape {smooth_state.shape}; "
                    "pass back exactly what return_carry returned")
        req = _Request(frames_u8, crop=border_crop, halo_in=halo_in,
                       smooth_state=smooth_state, return_state=return_carry)
        # The lock orders submission against close(): a request queued
        # after the worker took the shutdown sentinel would wait forever.
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("BatchStabilizer is closed")
            self._q.put(req)
        req.done.wait()
        if req.error is not None:
            raise req.error
        if return_carry:
            return req.output, req.out_carry
        return req.output

    def close(self):
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._worker.join()
        # Fail anything the worker never picked up.
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item.error = RuntimeError("BatchStabilizer closed")
                item.done.set()

    # -- device worker --------------------------------------------------

    def _run(self):
        # Inference mode and the current device belong to a thread: set
        # both here, in the worker, for every step it runs.
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            self._serve()

    def _serve(self):
        while True:
            first = self._q.get()
            if first is None:
                return
            group = [first]
            deadline = time.monotonic() + self.window_s
            while len(group) < self.max_batch:
                left = deadline - time.monotonic()
                try:
                    # After the window, still sweep what is already queued.
                    item = (self._q.get(timeout=left) if left > 0
                            else self._q.get_nowait())
                except queue.Empty:
                    break
                if item is None:
                    self._q.put(None)     # re-arm shutdown, finish group
                    break
                group.append(item)
            self.stats["requests"] += len(group)
            self.stats["max_group"] = max(self.stats["max_group"],
                                          len(group))
            by_key: Dict[tuple, List[_Request]] = {}
            for r in group:
                carries = (r.return_state or r.halo_in is not None
                           or r.smooth_state is not None)
                by_key.setdefault(
                    (r.frames.shape[1:], r.crop,
                     r.frames.shape[0] if carries else None),
                    []).append(r)
            for (_, crop, _), items in by_key.items():
                try:
                    self._run_group(items, crop)
                except Exception as e:     # noqa: BLE001 — hand errors back
                    for r in items:
                        r.error = e
                        r.done.set()

    def _group_cfg(self, crop: Optional[float]) -> StabilizeConfig:
        return (self.cfg if crop is None
                else self.cfg.replace(border_crop=crop))

    def _run_group(self, items: List[_Request],
                   crop: Optional[float] = None):
        b = len(items)
        bp = 1
        while bp < b:
            bp *= 2
        lens = [r.frames.shape[0] for r in items]
        max_len = max(lens)
        clips = []
        for r in items:
            c = r.frames
            if c.shape[0] < max_len:
                c = np.concatenate(
                    [c, np.repeat(c[-1:], max_len - c.shape[0], axis=0)])
            clips.append(c)
        clips += [clips[0]] * (bp - b)          # pad to the pow2 batch
        batch = np.stack(clips)                 # (bp, max_len, H, W, C)

        cfg = self._group_cfg(crop)
        any_ret = any(r.return_state for r in items)
        init_halos = carry = None
        if any(r.halo_in is not None for r in items):
            hs = [r.halo_in if r.halo_in is not None
                  else initial_halo(cfg, r.frames[0],
                                    self.device).cpu().numpy()
                  for r in items]
            init_halos = np.stack(hs + [hs[0]] * (bp - b))
        if any(r.smooth_state is not None for r in items):
            fresh = np.zeros((pathsmooth.STATE_DIM,), np.float32)
            ss = [r.smooth_state if r.smooth_state is not None else fresh
                  for r in items]
            carry = (torch.from_numpy(np.stack(ss + [ss[0]] * (bp - b))
                                      ).to(self.device),)
        step = ChunkStep(cfg, self.model, batched=True, carry=carry)
        full = drive_chunked_batch(step, batch, fetch_clips=b,
                                   initial_halos=init_halos,
                                   return_halos=any_ret)
        if any_ret:
            full, final_halos = full
            final_halos = final_halos.cpu().numpy()
            final_states = step.carry[0].cpu().numpy()
        self.stats["batches"] += 1
        if crop is not None:
            seen = self.stats.get("crops_seen", [])
            if crop not in seen:
                # Replace, never mutate: /healthz threads copy this list
                # while the worker runs.
                self.stats["crops_seen"] = sorted(seen + [crop])
        for i, r in enumerate(items):
            # A copy: a slice would keep the whole group's batch alive for
            # as long as any caller holds its output.
            r.output = np.ascontiguousarray(full[i, :lens[i]])
            if r.return_state:
                r.out_carry = (final_halos[i].copy(), final_states[i].copy())
            r.done.set()
