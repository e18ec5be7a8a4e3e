"""Host frame staging: page-aligned NHWC buffers and the BGR↔RGB channel
swap of video I/O.

The per-byte work runs in the ``_dvsg_torch_native`` C++ extension
(native/staging.cpp: a persistent thread pool that takes concurrent callers
one submission at a time), built at first use by native/build.py. A build
that fails raises with the compiler's stderr; nothing falls back to numpy
quietly. ``bgr_to_rgb_plain`` is the numpy version the tests hold the
extension to.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np

_native = None
_native_lock = threading.Lock()


def native():
    """The ``_dvsg_torch_native`` module, built and loaded on first use."""
    global _native
    with _native_lock:
        if _native is None:
            from dvsg_tpu_torch.native import build as native_build
            _native = native_build.load()
    return _native


def _check_frames(src: np.ndarray) -> None:
    if src.dtype != np.uint8 or src.shape[-1] != 3:
        raise ValueError(f"expected (..., 3) uint8, got {src.dtype} "
                         f"{src.shape}")


def bgr_to_rgb_plain(src: np.ndarray, out: Optional[np.ndarray] = None
                     ) -> np.ndarray:
    """The plain numpy version of ``bgr_to_rgb``."""
    _check_frames(src)
    if out is None:
        out = np.empty_like(src)
    np.copyto(out, src[..., ::-1])
    return out


def bgr_to_rgb(src: np.ndarray, out: Optional[np.ndarray] = None
               ) -> np.ndarray:
    """(..., 3) uint8 BGR → RGB in one fused pass of the extension (the
    same swap turns RGB into BGR). ``out`` must be a C-contiguous uint8
    array of ``src``'s shape."""
    _check_frames(src)
    src = np.ascontiguousarray(src)
    if out is None:
        out = np.empty_like(src)
    elif not out.flags.c_contiguous:
        # reshape(-1) of a non-contiguous out would be a copy: the swap
        # would land in a temporary and be lost.
        raise ValueError("out buffer must be C-contiguous")
    elif out.dtype != np.uint8 or out.shape != src.shape:
        raise ValueError(f"out must be uint8 {src.shape}, got {out.dtype} "
                         f"{out.shape}")
    native().bgr_to_rgb_batch(src.reshape(-1), out.reshape(-1))
    return out


def stack_frames(frames: List[np.ndarray], out: Optional[np.ndarray] = None
                 ) -> np.ndarray:
    """Stack T (H, W, C) uint8 frames into a staging (T, H, W, C) buffer
    (page-aligned when made here) with the extension's parallel copy."""
    t = len(frames)
    h, w, c = frames[0].shape
    if out is None:
        out = alloc_staging((t, h, w, c))
    mod = native()
    for i, f in enumerate(frames):
        mod.copy_batch(np.ascontiguousarray(f).reshape(-1),
                       out[i].reshape(-1))
    return out[:t]


def alloc_staging(shape, dtype=np.uint8, alignment: int = 4096
                  ) -> np.ndarray:
    """A page-aligned staging buffer (DMA-friendly host→device copies)."""
    size = int(np.prod(shape)) * np.dtype(dtype).itemsize
    raw = np.empty(size + alignment, np.uint8)
    offset = (-raw.ctypes.data) % alignment
    return raw[offset:offset + size].view(dtype).reshape(shape)


class StagingRing:
    """A fixed pool of page-aligned NHWC staging buffers, reused round-robin.

    Each slot belongs to one pipeline stage at a time (decode, then the
    upload), and the ring takes the per-chunk allocations out of the steady
    state loop.
    """

    def __init__(self, depth: int, shape, dtype=np.uint8):
        self._slots = [alloc_staging(shape, dtype) for _ in range(depth)]
        self._idx = 0

    def next_slot(self) -> np.ndarray:
        s = self._slots[self._idx]
        self._idx = (self._idx + 1) % len(self._slots)
        return s
