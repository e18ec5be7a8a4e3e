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


def grid_to_pixel_coords(grid: torch.Tensor, height: int, width: int):
    """Unnormalize an align_corners=True grid to pixel coordinates (x, y)."""
    x = (grid[..., 0] + 1.0) * 0.5 * (width - 1)
    y = (grid[..., 1] + 1.0) * 0.5 * (height - 1)
    return x, y


def _homogeneous(height: int, width: int, device) -> torch.Tensor:
    base = identity_grid(height, width, device)            # (H, W, 2)
    return torch.cat([base, torch.ones_like(base[..., :1])], dim=-1)


def affine_grid(theta: torch.Tensor, height: int, width: int
                ) -> torch.Tensor:
    """Sampling grid(s) (..., H, W, 2) for 2x3 affine matrices (..., 2, 3)
    acting on normalized coords; ``theta`` maps output coords to input
    coords (the convention of ``torch.nn.functional.affine_grid``)."""
    homo = _homogeneous(height, width, theta.device)
    return torch.einsum("hwk,...ck->...hwc", homo, theta.to(homo.dtype))


def homography_grid(hmat: torch.Tensor, height: int, width: int
                    ) -> torch.Tensor:
    """Sampling grid(s) (..., H, W, 2) for 3x3 homographies (..., 3, 3) on
    normalized coords: (x', y', w') = H @ (x, y, 1); grid = (x'/w', y'/w').
    Mild camera perspectives keep w' near 1; no sign handling."""
    homo = _homogeneous(height, width, hmat.device)
    out = torch.einsum("hwk,...ck->...hwc", homo, hmat.to(homo.dtype))
    return out[..., :2] / out[..., 2:]
