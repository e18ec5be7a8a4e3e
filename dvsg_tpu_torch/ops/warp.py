"""Warp dispatch for the pipeline.

``warp_quantize_batch`` is the fused normalize + warp + quantize step:
uint8 frames in, uint8 frames out. From coarse offsets it runs
ops/warp_wide.py (the CUDA kernel on the card, its plain version on the
CPU). Dense grids need the dense-grid uint8 kernel, which is not ported
yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from dvsg_tpu_torch.ops import warp_wide


def warp_quantize_batch(frames_u8: torch.Tensor,
                        grids: Optional[torch.Tensor] = None,
                        offsets: Optional[torch.Tensor] = None,
                        border_crop: float = 0.0) -> torch.Tensor:
    """(B, H, W, C) uint8 frames warped by coarse ``offsets``
    (B, gh, gw, 2) with ``border_crop`` → (B, H, W, C) uint8."""
    if grids is not None:
        raise NotImplementedError(
            "warp_quantize_batch(grids=...): the dense-grid uint8 kernel is "
            "not ported yet; pass offsets=")
    if offsets is None:
        raise ValueError("warp_quantize_batch needs `offsets`")
    return warp_wide.warp_u8_offsets(frames_u8, offsets,
                                     border_crop=border_crop)
