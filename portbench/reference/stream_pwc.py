"""One chunk of the stabilized stream with PWC-Net as the motion
estimator (``reference/pwc.py``), in plain PyTorch: ``reference/
stream.py::chunk`` with the offsets of ``pwc.window_offsets`` in place
of the corr arch's. The resize, the halo, the dense grid and the frame
warp are that file's."""

from __future__ import annotations

import torch

from portbench.reference import pwc, resize
from portbench.reference.stream import dense_grid, warp


@torch.no_grad()
def offsets(p: dict, cfg: dict, frames_u8: torch.Tensor,
            prev_u8: torch.Tensor | None, **faults) -> torch.Tensor:
    """The chunk's coarse offsets (T, gh, gw, 2) from its uint8 frames and
    the previous chunk's (None for the first); ``faults`` go to
    ``pwc.flow``."""
    n = cfg["window"]
    mh, mw = cfg["model_size"]
    small = resize.downscale_norm(frames_u8, mh, mw)
    if prev_u8 is None:
        halo = small[:1].expand(n - 1, -1, -1, -1)
    else:
        halo = resize.downscale_norm(prev_u8[-(n - 1):], mh, mw)
    seq = torch.cat([halo, small])
    return pwc.window_offsets(p, cfg, seq, frames_u8.shape[0], **faults)


@torch.no_grad()
def chunk(p: dict, cfg: dict, frames_u8: torch.Tensor,
          prev_u8: torch.Tensor | None, **faults) -> torch.Tensor:
    """Stabilized chunk (T, H, W, C) float in [0, 1] from the chunk's
    uint8 frames and the previous chunk's (None for the first)."""
    _, h, w, _ = frames_u8.shape
    grids = dense_grid(offsets(p, cfg, frames_u8, prev_u8, **faults), h, w)
    return warp(frames_u8.to(torch.float32) / 255.0, grids)
