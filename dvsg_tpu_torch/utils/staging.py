"""Host frame staging: the BGR↔RGB channel swap of video I/O (numpy)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def bgr_to_rgb(src: np.ndarray, out: Optional[np.ndarray] = None
               ) -> np.ndarray:
    """(..., 3) uint8 BGR → RGB (the same swap turns RGB into BGR)."""
    if src.dtype != np.uint8 or src.shape[-1] != 3:
        raise ValueError(f"expected (..., 3) uint8, got {src.dtype} "
                         f"{src.shape}")
    if out is None:
        out = np.empty_like(src)
    np.copyto(out, src[..., ::-1])
    return out
