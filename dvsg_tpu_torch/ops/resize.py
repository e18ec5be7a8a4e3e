"""Matrix-form separable bilinear resize.

Bilinear resize with an antialiasing triangle kernel when minifying is
linear and separable, so it is two matrix products:

    out = R @ x @ C^T        R: (oh, h),  C: (ow, w)

``_resize_matrix`` builds R and C in numpy from the weight formula of
``jax.image.resize(method="bilinear")`` (the reference's operator), in the
same float32 steps, so both packages sample the same way.

``downscale_norm`` folds the pipeline's uint8 normalization into the row
matrix: (R/255) @ x @ C^T - 0.5 == resize(x/255) - 0.5, because the
operator rows sum to 1.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 matrix M with M @ x == bilinear resize of x.

    Sample position of output p is (p + 0.5) * n_in / n_out - 0.5; the
    triangle kernel is widened by max(n_in / n_out, 1) (antialias when
    minifying); each output's weights are normalized by their sum; outputs
    whose sample falls outside [-0.5, n_in - 0.5] are zero.
    """
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)               # (n_in, n_out)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = np.where(inside[None, :], w, f32(0.0))
    m = np.ascontiguousarray(w.T.astype(f32))
    m.setflags(write=False)          # cached and shared by every caller
    return m


@functools.lru_cache(maxsize=64)
def _matrix_on(n_in: int, n_out: int, scale: float,
               device: torch.device) -> torch.Tensor:
    m = _resize_matrix(n_in, n_out) * np.float32(scale)
    return torch.from_numpy(m).to(device)


def _matrix(n_in: int, n_out: int, like: torch.Tensor,
            scale: float = 1.0) -> torch.Tensor:
    """The resize matrix as a tensor on ``like``'s device (cached, so a
    chunk loop uploads it once)."""
    return _matrix_on(n_in, n_out, scale, like.device)


def downscale_bilinear(frames: torch.Tensor, oh: int, ow: int
                       ) -> torch.Tensor:
    """(..., H, W, C) f32 → (..., oh, ow, C) with jax.image.resize bilinear
    (antialiased) semantics, as two matrix products."""
    *_, h, w, _ = frames.shape
    r = _matrix(h, oh, frames)
    cm = _matrix(w, ow, frames)
    y = torch.einsum("ph,...hwc->...pwc", r, frames)
    return torch.einsum("qw,...pwc->...pqc", cm, y)


def downscale_norm(frames_u8: torch.Tensor, oh: int, ow: int
                   ) -> torch.Tensor:
    """uint8 (..., H, W, C) → f32 (..., oh, ow, C) centered at 0:
    resize(frames / 255) - 0.5, with the 1/255 folded into the row matrix
    so no full-resolution normalized frame is built."""
    *_, h, w, _ = frames_u8.shape
    r = _matrix(h, oh, frames_u8, scale=1.0 / 255.0)
    cm = _matrix(w, ow, frames_u8)
    x = frames_u8.to(torch.float32)
    y = torch.einsum("ph,...hwc->...pwc", r, x)
    return torch.einsum("qw,...pwc->...pqc", cm, y) - 0.5
