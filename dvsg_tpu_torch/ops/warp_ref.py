"""Reference bilinear grid-sample warp in plain PyTorch: the f32 oracle.

Semantics: ``grid_sample(mode="bilinear", padding_mode="border",
align_corners=True)``, written out as a four-tap gather so the rounding
of every step is the reference's. It is the plain version the CUDA warp
kernels are held against (ops/warp_bilinear.py, ops/warp_wide.py).
"""

from __future__ import annotations

import torch


def bilinear_taps(frames: torch.Tensor, grids: torch.Tensor):
    """The four border-clamped taps of every output pixel and its
    fractional position: (v00, v01, v10, v11) each (B, Ho, Wo, C) f32 and
    (fx, fy) each (B, Ho, Wo, 1), for frames (B, H, W, C) sampled at grids
    (B, Ho, Wo, 2). Float64 frames are sampled in float64 (finite-difference
    checks); every other type in f32."""
    b, h, w, c = frames.shape
    ft = torch.float64 if frames.dtype == torch.float64 else torch.float32
    src = frames.to(ft).reshape(b, h * w, c)

    x = (grids[..., 0].to(ft) + 1.0) * 0.5 * (w - 1)
    y = (grids[..., 1].to(ft) + 1.0) * 0.5 * (h - 1)
    # Border padding: clamp the sampling location itself, then the +1
    # neighbor index.
    x = torch.clamp(x, 0.0, w - 1)
    y = torch.clamp(y, 0.0, h - 1)

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = torch.clamp(x0i + 1, max=w - 1)
    y1i = torch.clamp(y0i + 1, max=h - 1)

    def tap(yi, xi):
        idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(src, 1, idx).reshape(*xi.shape, c)

    return ((tap(y0i, x0i), tap(y0i, x1i), tap(y1i, x0i), tap(y1i, x1i)),
            (fx, fy))


def bilinear_warp_batch(frames: torch.Tensor, grids: torch.Tensor
                        ) -> torch.Tensor:
    """Warp frames (B, H, W, C) by grids (B, Ho, Wo, 2) → (B, Ho, Wo, C).

    Grids are normalized (x, y) in [-1, 1], align_corners=True; output
    resolution follows the grid; interpolation in f32, output in
    frames.dtype.
    """
    (v00, v01, v10, v11), (fx, fy) = bilinear_taps(frames, grids)
    top = v00 + (v01 - v00) * fx
    bot = v10 + (v11 - v10) * fx
    out = top + (bot - top) * fy
    return out.to(frames.dtype)


def bilinear_warp(frame: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Warp one frame (H, W, C) by one grid (Ho, Wo, 2) → (Ho, Wo, C)."""
    return bilinear_warp_batch(frame[None], grid[None])[0]


def warp_quantize_oracle(frames_u8: torch.Tensor, grids: torch.Tensor
                         ) -> torch.Tensor:
    """quantize(warp(normalize(frames_u8))): the one definition of the
    fused uint8 path's semantics. ``torch.round`` rounds half to even,
    as the reference does."""
    out = bilinear_warp_batch(frames_u8.to(torch.float32) * (1.0 / 255.0),
                              grids)
    return torch.clamp(torch.round(out * 255.0), 0, 255).to(torch.uint8)
