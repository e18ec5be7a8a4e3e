"""Host-side video I/O: container decode/encode and frame-directory access.

Frames are NHWC uint8 RGB numpy arrays. Containers go through
``cv2.VideoCapture``/``cv2.VideoWriter`` and frame directories through
cv2's image codecs. OpenCV is imported when a reader or writer is made,
so the rest of the package works on a machine without it.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Sequence

import numpy as np

from dvsg_tpu_torch.utils import staging

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp")
_VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v")


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("OpenCV (cv2) is required for video I/O") from e
    return cv2


def is_frame_dir(path: str) -> bool:
    return os.path.isdir(path)


def is_container_path(path: str) -> bool:
    """True when ``path`` would be written as a video container (vs a
    frame directory): the extension rule VideoWriter applies."""
    return os.path.splitext(path)[1].lower() in _VIDEO_EXTS


def _natural_key(name: str):
    """Sort key treating digit runs numerically, so unpadded numeric frame
    names (frame1, frame2, ..., frame10) keep temporal order."""
    return [int(p) if p.isdigit() else p
            for p in re.split(r"(\d+)", name.lower())]


def list_frames(path: str) -> Sequence[str]:
    names = sorted(
        (n for n in os.listdir(path)
         if os.path.splitext(n)[1].lower() in _IMAGE_EXTS),
        key=_natural_key,
    )
    return [os.path.join(path, n) for n in names]


class VideoReader:
    """Reads a video container or a frame directory as uint8 RGB NHWC."""

    def __init__(self, path: str):
        cv2 = self._cv2 = _cv2()
        self.path = path
        self._cap = None
        self._frames: Optional[Sequence[str]] = None
        if is_frame_dir(path):
            self._frames = list_frames(path)
            if not self._frames:
                raise FileNotFoundError(f"no image frames in {path}")
            first = cv2.imread(self._frames[0], cv2.IMREAD_COLOR)
            if first is None:
                raise IOError(f"cannot read frame {self._frames[0]}")
            self.height, self.width = first.shape[:2]
            self.fps = 30.0
            self.num_frames: Optional[int] = len(self._frames)
        else:
            if not os.path.exists(path):
                raise FileNotFoundError(path)
            self._cap = cv2.VideoCapture(path)
            if not self._cap.isOpened():
                raise IOError(f"cannot open video {path}")
            self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            self.fps = float(self._cap.get(cv2.CAP_PROP_FPS)) or 30.0
            n = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
            self.num_frames = n if n > 0 else None
        self._pos = 0

    def read(self, out: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
        """Next frame as (H, W, 3) uint8 RGB, or None at end of stream."""
        cv2 = self._cv2
        if self._frames is not None:
            if self._pos >= len(self._frames):
                return None
            bgr = cv2.imread(self._frames[self._pos], cv2.IMREAD_COLOR)
            if bgr is None:
                raise IOError(f"cannot read frame {self._frames[self._pos]}")
        else:
            ok, bgr = self._cap.read()
            if not ok:
                return None
        self._pos += 1
        if bgr.shape[:2] != (self.height, self.width):
            bgr = cv2.resize(bgr, (self.width, self.height))
        return staging.bgr_to_rgb(bgr, out)

    def read_batch(self, n: int, out: Optional[np.ndarray] = None
                   ) -> np.ndarray:
        """Up to n frames stacked (T, H, W, 3) uint8 RGB; T may be < n."""
        if out is None:
            out = np.empty((n, self.height, self.width, 3), np.uint8)
        t = 0
        for i in range(n):
            if self.read(out=out[i]) is None:
                break
            t = i + 1
        return out[:t]

    def skip(self, n: int) -> int:
        """Skip forward n frames (for streaming resume); returns skipped."""
        if self._frames is not None:
            skipped = min(n, len(self._frames) - self._pos)
            self._pos += skipped
            return skipped
        skipped = 0
        for _ in range(n):
            if not self._cap.grab():
                break
            skipped += 1
        self._pos += skipped
        return skipped

    def close(self):
        if self._cap is not None:
            self._cap.release()
            self._cap = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class VideoWriter:
    """Writes uint8 RGB NHWC frames to a container or a frame directory."""

    def __init__(self, path: str, width: int, height: int, fps: float = 30.0):
        cv2 = self._cv2 = _cv2()
        self.path = path
        self.width, self.height, self.fps = width, height, fps
        self._pos = 0
        ext = os.path.splitext(path)[1].lower()
        if ext in _VIDEO_EXTS:
            self._dir = None
            # mp4-family takes mpeg4; webm only VP8/VP9; avi/mkv MJPG.
            if ext in (".mp4", ".m4v", ".mov"):
                codec = "mp4v"
            elif ext == ".webm":
                codec = "VP80"
            else:
                codec = "MJPG"
            self._writer = cv2.VideoWriter(
                path, cv2.VideoWriter_fourcc(*codec), fps, (width, height))
            if not self._writer.isOpened():
                raise IOError(f"cannot open video writer for {path}")
            # The default codec quality is low enough to dominate
            # stabilization quality measurements.
            self._writer.set(cv2.VIDEOWRITER_PROP_QUALITY, 95)
        else:
            self._writer = None
            self._dir = path
            os.makedirs(path, exist_ok=True)
        self._bgr_scratch = np.empty((height, width, 3), np.uint8)

    @property
    def appendable(self) -> bool:
        """Frame-dir outputs can resume mid-stream; containers cannot."""
        return self._dir is not None

    def seek(self, frame_index: int):
        """Position the writer for resume (frame-dir outputs only)."""
        if not self.appendable:
            raise ValueError(
                "cannot resume into a video container; use a frame "
                "directory output for resumable jobs")
        self._pos = frame_index

    def write(self, frame: np.ndarray):
        """frame: (H, W, 3) uint8 RGB."""
        if frame.shape != (self.height, self.width, 3):
            # cv2.VideoWriter.write silently drops wrong-size frames.
            raise ValueError(
                f"frame shape {frame.shape} does not match the writer's "
                f"({self.height}, {self.width}, 3)")
        bgr = staging.bgr_to_rgb(frame, out=self._bgr_scratch)
        if self._writer is not None:
            self._writer.write(bgr)
        else:
            self._cv2.imwrite(os.path.join(self._dir, f"{self._pos:06d}.png"),
                              bgr)
        self._pos += 1

    def write_batch(self, frames: np.ndarray):
        for f in frames:
            self.write(f)

    def close(self):
        if self._writer is not None:
            self._writer.release()
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
