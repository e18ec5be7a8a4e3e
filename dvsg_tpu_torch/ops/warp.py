"""Warp dispatch: the package's three warps behind one module.

* ``warp_batch`` — f32 frames through dense grids (ops/warp_bilinear.py);
  renders training data, no gradient.
* ``warp_batch_diff`` — the same warp, differentiable with respect to the
  grids only (frames are data): the training loss's warp.
* ``warp_quantize_batch`` — the fused normalize + warp + quantize step,
  uint8 frames in, uint8 frames out (ops/warp_wide.py): from coarse
  ``offsets`` (the pipeline case; no dense grid is built) or from dense
  ``grids`` (any output resolution).

Each runs its CUDA kernel on CUDA tensors and its plain version on CPU
tensors; there is no implementation switch to pass.
"""

from __future__ import annotations

from typing import Optional

import torch

from dvsg_tpu_torch.ops import warp_bilinear, warp_wide


def warp_batch(frames: torch.Tensor, grids: torch.Tensor) -> torch.Tensor:
    """frames (B, H, W, C) × grids (B, Ho, Wo, 2) → warped (B, Ho, Wo, C)."""
    return warp_bilinear.bilinear_warp_batch(frames, grids)


def warp_batch_diff(frames: torch.Tensor, grids: torch.Tensor
                    ) -> torch.Tensor:
    """Training-path warp: differentiable w.r.t. GRIDS (frames constant).
    Callers must not rely on frame gradients through this op."""
    return warp_bilinear.bilinear_warp_batch_grids_diff(frames, grids)


def warp_quantize_batch(frames_u8: torch.Tensor,
                        grids: Optional[torch.Tensor] = None,
                        offsets: Optional[torch.Tensor] = None,
                        border_crop: float = 0.0) -> torch.Tensor:
    """(B, H, W, C) uint8 frames → uint8, warped by coarse ``offsets``
    (B, gh, gw, 2) with ``border_crop`` (output (B, H, W, C)), or by dense
    ``grids`` (B, Ho, Wo, 2) (output (B, Ho, Wo, C)). ``grids`` wins when
    both are given, as in the reference."""
    if grids is None and offsets is None:
        raise ValueError("warp_quantize_batch needs `grids` or `offsets`")
    if grids is not None:
        return warp_wide.warp_u8_batch(frames_u8, grids)
    return warp_wide.warp_u8_offsets(frames_u8, offsets,
                                     border_crop=border_crop)
