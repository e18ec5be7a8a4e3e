"""Online (push) stabilization API for live sources.

Feed frames one at a time and receive stabilized frames as each chunk
fills; the latency is ``chunk_frames`` frames. The causal path smoother
(cfg.path_smooth > 0) is supported: its state threads through
``push``/``flush`` exactly as through ``Stabilizer.stabilize_clip``, so the
output is byte-identical to it on the same frames. The fixed-lag mode is
refused: a live consumer cannot pay its D-frame delay.

End of stream: ``flush()`` pads its partial chunk by replicating the last
frame, which advances the carried halo and smoothing state past the true
stream position, so a flushed stream is ended — ``push`` raises until
``reset()``.
"""

from __future__ import annotations

from typing import List

import numpy as np

from dvsg_tpu_torch.config import StabilizeConfig
from dvsg_tpu_torch.pipeline import pathsmooth
from dvsg_tpu_torch.pipeline.stabilize import (Stabilizer, fetch_frames,
                                               put_frames)


class OnlineStabilizer:
    """Push frames in, get stabilized frames out, chunk by chunk.

    >>> s = OnlineStabilizer(cfg, params)
    >>> for frame in source:
    ...     for out in s.push(frame):
    ...         sink(out)
    >>> for out in s.flush():
    ...     sink(out)
    """

    def __init__(self, cfg: StabilizeConfig, params: dict, device="cuda"):
        pathsmooth.lag_reject(
            cfg, "the online push surface (live consumers cannot pay a "
                 "D-frame output delay; the causal smoother is supported "
                 "here)")
        self.cfg = cfg
        self._stab = Stabilizer(cfg, params, device=device)
        self.device = self._stab.device
        self._buf: List[np.ndarray] = []
        self._halo = None
        self._ended = False

    def _process(self, frames: np.ndarray, n_valid: int) -> np.ndarray:
        if self._halo is None:
            self._halo = self._stab._initial_halo(frames[0])
            self._stab.begin_stream()
        out, self._halo, _ = self._stab._chunk(
            put_frames(frames, self.device), self._halo)
        return fetch_frames(out[:n_valid])

    def push(self, frame: np.ndarray) -> List[np.ndarray]:
        """Add one (H, W, C) uint8 frame; returns 0 or chunk_frames
        stabilized frames."""
        if self._ended:
            raise RuntimeError(
                "this stream was ended by flush() (its replicate-padding "
                "advanced the carried state past the true stream "
                "position); call reset() to start a new stream")
        frame = np.asarray(frame)
        if frame.dtype != np.uint8:
            # A float frame in [0, 1] would survive a cast as near-black
            # garbage: the contract is 0..255 uint8.
            raise TypeError(
                f"push() needs uint8 frames in [0, 255], got "
                f"{frame.dtype}; scale and cast explicitly")
        if frame.ndim != 3:
            raise ValueError(f"push() needs one (H, W, C) frame, got "
                             f"shape {frame.shape}")
        self._buf.append(frame)
        if len(self._buf) < self.cfg.chunk_frames:
            return []
        chunk = np.stack(self._buf)
        self._buf.clear()
        return list(self._process(chunk, chunk.shape[0]))

    def flush(self) -> List[np.ndarray]:
        """Process the buffered partial chunk (replicate-padded) and end
        the stream; on an empty buffer a no-op that leaves it open."""
        if not self._buf:
            return []
        n_valid = len(self._buf)
        chunk = np.stack(self._buf)
        self._buf.clear()
        pad = np.repeat(chunk[-1:], self.cfg.chunk_frames - n_valid, axis=0)
        self._ended = True
        return list(self._process(np.concatenate([chunk, pad]), n_valid))

    def reset(self) -> None:
        """Drop buffered frames and the streaming state (new scene or
        source)."""
        self._buf.clear()
        self._halo = None
        self._stab.begin_stream()
        self._ended = False
