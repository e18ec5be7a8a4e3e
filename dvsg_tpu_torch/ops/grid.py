"""Warp-grid construction.

Convention: a sampling grid has shape ``(..., H, W, 2)`` with last dim
``(x, y)`` normalized to ``[-1, 1]`` with align_corners=True semantics
(``-1`` is pixel 0, ``+1`` is pixel ``S - 1``); out-of-range coordinates
sample with border clamping.
"""

from __future__ import annotations

import torch

from dvsg_tpu_torch.ops import resize as resize_ops


def identity_grid(height: int, width: int, device="cpu") -> torch.Tensor:
    """Identity sampling grid, shape (H, W, 2), last dim (x, y) in [-1, 1]."""
    xs = torch.linspace(-1.0, 1.0, width, dtype=torch.float32, device=device)
    ys = torch.linspace(-1.0, 1.0, height, dtype=torch.float32,
                        device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def upsample_offsets(offsets: torch.Tensor, height: int, width: int
                     ) -> torch.Tensor:
    """Bilinearly upsample coarse offsets (..., gh, gw, 2) → (..., H, W, 2).

    Offsets are in normalized units, so upsampling does not rescale them.
    """
    return resize_ops.downscale_bilinear(offsets.to(torch.float32),
                                         height, width)


def grid_from_offsets(offsets: torch.Tensor, height: int, width: int,
                      border_crop: float = 0.0) -> torch.Tensor:
    """Full-resolution sampling grid(s) from coarse offsets (..., gh, gw, 2):
    identity + upsampled offsets.

    ``border_crop``: fraction of each border hidden by zooming the identity
    toward the center (scale 1 - 2*crop), folded into the same warp.
    """
    if not 0.0 <= border_crop < 0.5:
        raise ValueError(
            f"border_crop must be in [0, 0.5), got {border_crop}")
    dense = upsample_offsets(offsets, height, width)
    scale = 1.0 - 2.0 * border_crop
    return identity_grid(height, width, offsets.device) * scale + dense
