"""One chunk of the stabilized stream, in plain PyTorch.

Chunk k of a stream is stabilized from its own T frames and the last
N - 1 frames of chunk k - 1 (the first chunk repeats its first frame):
every frame is resized to the model's input, the CNN gives each of the T
windows coarse offsets, the offsets are upsampled bilinearly to a dense
grid (identity plus offsets, align-corners coordinates), and each frame,
read as float in [0, 1], is sampled through its grid with border
clamping. The result is left in float, in [0, 1]; the caller rounds it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import cnn, resize


def identity_grid(h: int, w: int, device) -> torch.Tensor:
    xs = torch.linspace(-1.0, 1.0, w, device=device)
    ys = torch.linspace(-1.0, 1.0, h, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def dense_grid(offsets: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Coarse offsets (B, gh, gw, 2) → sampling grids (B, h, w, 2)."""
    return identity_grid(h, w, offsets.device) + resize.resize(
        offsets, h, w, "linear")


def warp(frames: torch.Tensor, grids: torch.Tensor) -> torch.Tensor:
    """Frames (B, H, W, C) float sampled bilinearly at grids (B, Ho, Wo, 2),
    border-clamped, align-corners; (B, Ho, Wo, C)."""
    out = F.grid_sample(frames.permute(0, 3, 1, 2), grids, mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out.permute(0, 2, 3, 1)


@torch.no_grad()
def chunk(p: dict, cfg: dict, frames_u8: torch.Tensor,
          prev_u8: torch.Tensor | None) -> torch.Tensor:
    """Stabilized chunk (T, H, W, C) float in [0, 1] from the chunk's
    uint8 frames and the previous chunk's (None for the first)."""
    n = cfg["window"]
    mh, mw = cfg["model_size"]
    t, h, w, _ = frames_u8.shape
    small = resize.downscale_norm(frames_u8, mh, mw)
    if prev_u8 is None:
        halo = small[:1].expand(n - 1, -1, -1, -1)
    else:
        halo = resize.downscale_norm(prev_u8[-(n - 1):], mh, mw)
    seq = torch.cat([halo, small])
    offsets = cnn.window_offsets(p, cfg, seq, t)
    grids = dense_grid(offsets, h, w)
    return warp(frames_u8.to(torch.float32) / 255.0, grids)
