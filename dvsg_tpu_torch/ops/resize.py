"""Matrix-form separable resize (bilinear, and bicubic for upsampling).

Bilinear resize with an antialiasing triangle kernel when minifying is
linear and separable, so it is two matrix products:

    out = R @ x @ C^T        R: (oh, h),  C: (ow, w)

``_resize_matrix`` builds R and C in numpy from the weight formula of
``jax.image.resize(method="bilinear")`` (the reference's operator), in the
same float32 steps, so both packages sample the same way. With
``method="cubic"`` it is the reference's ``method="bicubic"``: the Keys
kernel with a = -0.5, its weights renormalized over the taps that fall
inside the input (``F.interpolate(mode="bicubic")`` uses a = -0.75 with
clamped taps and does not match).

``downscale_norm`` folds the pipeline's uint8 normalization into the row
matrix: (R/255) @ x @ C^T - 0.5 == resize(x/255) - 0.5, because the
operator rows sum to 1.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys cubic convolution kernel, a = -0.5, of |distance| x (f32)."""
    f32 = np.float32
    out = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    out = np.where(x >= 1.0,
                   ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0),
                   out)
    return np.where(x >= 2.0, f32(0.0), out).astype(f32)


@functools.lru_cache(maxsize=64)
def _resize_matrix(n_in: int, n_out: int, method: str = "linear"
                   ) -> np.ndarray:
    """(n_out, n_in) float32 matrix M with M @ x == resize of x.

    Sample position of output p is (p + 0.5) * n_in / n_out - 0.5; the
    kernel (triangle for "linear", Keys cubic for "cubic") is widened by
    max(n_in / n_out, 1) (antialias when minifying); each output's weights
    are normalized by their sum; outputs whose sample falls outside
    [-0.5, n_in - 0.5] are zero.
    """
    if method not in ("linear", "cubic"):
        raise ValueError(f"unknown resize method {method!r}")
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    if method == "linear":
        w = np.maximum(f32(0.0), f32(1.0) - x)           # (n_in, n_out)
    else:
        w = _keys_cubic(x)
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
               device: torch.device, method: str) -> torch.Tensor:
    m = _resize_matrix(n_in, n_out, method) * np.float32(scale)
    # The cache outlives its first caller: a matrix made under
    # inference_mode (the stabilizer's chunk step) would be an inference
    # tensor, which a later training step could not save for backward.
    with torch.inference_mode(False):
        return torch.from_numpy(m).to(device)


def _matrix(n_in: int, n_out: int, like: torch.Tensor,
            scale: float = 1.0, method: str = "linear") -> torch.Tensor:
    """The resize matrix as a tensor on ``like``'s device (cached, so a
    chunk loop uploads it once)."""
    return _matrix_on(n_in, n_out, scale, like.device, method)


def downscale_bilinear(frames: torch.Tensor, oh: int, ow: int
                       ) -> torch.Tensor:
    """(..., H, W, C) f32 → (..., oh, ow, C) with jax.image.resize bilinear
    (antialiased) semantics, as two matrix products."""
    *_, h, w, _ = frames.shape
    r = _matrix(h, oh, frames)
    cm = _matrix(w, ow, frames)
    y = torch.einsum("ph,...hwc->...pwc", r, frames)
    return torch.einsum("qw,...pwc->...pqc", cm, y)


def resize_bicubic(images: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """(..., H, W, C) f32 → (..., oh, ow, C) with the reference's
    ``jax.image.resize(method="bicubic")`` semantics, as two matrix
    products (rows first, as the reference contracts them)."""
    *_, h, w, _ = images.shape
    r = _matrix(h, oh, images, method="cubic")
    cm = _matrix(w, ow, images, method="cubic")
    y = torch.einsum("ph,...hwc->...pwc", r, images)
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
