"""Separable resize as two matrix products, in plain PyTorch and numpy.

The semantics of ``jax.image.resize`` with ``method="bilinear"`` (a
triangle kernel widened by the scale when minifying, so it antialiases)
and ``method="bicubic"`` (Keys' kernel with a = -0.5, its weights
renormalized over the taps that fall inside the input). Each output
sample sits at ``(p + 0.5) * n_in / n_out - 0.5``; its weights are
normalized by their sum, and a sample outside ``[-0.5, n_in - 0.5]`` is
zero. The matrices are built in float32 steps.
"""

from __future__ import annotations

import numpy as np
import torch


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    f32 = np.float32
    near = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    far = ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0)
    out = np.where(x >= 1.0, far, near)
    return np.where(x >= 2.0, f32(0.0), out).astype(f32)


def matrix(n_in: int, n_out: int, method: str = "linear") -> np.ndarray:
    """(n_out, n_in) float32 matrix M with M @ x the resize of x."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    if method == "linear":
        w = np.maximum(f32(0.0), f32(1.0) - dist)
    elif method == "cubic":
        w = _keys_cubic(dist)
    else:
        raise ValueError(f"unknown resize method {method!r}")
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = np.where(inside[None, :], w, f32(0.0))
    return np.ascontiguousarray(w.T.astype(f32))


def resize(x: torch.Tensor, oh: int, ow: int, method: str = "linear",
           scale: float = 1.0) -> torch.Tensor:
    """(..., H, W, C) float → (..., oh, ow, C); ``scale`` multiplies the
    row matrix (a normalization folded in)."""
    h, w = x.shape[-3], x.shape[-2]
    rows = torch.from_numpy(matrix(h, oh, method) * np.float32(scale)).to(
        x.device)
    cols = torch.from_numpy(matrix(w, ow, method)).to(x.device)
    y = torch.einsum("ph,...hwc->...pwc", rows, x.to(torch.float32))
    return torch.einsum("qw,...pwc->...pqc", cols, y)


def downscale_norm(frames_u8: torch.Tensor, oh: int, ow: int
                   ) -> torch.Tensor:
    """uint8 (..., H, W, C) → float32 (..., oh, ow, C): the bilinear resize
    of frames / 255, centred at 0."""
    return resize(frames_u8, oh, ow, "linear", 1.0 / 255.0) - 0.5
