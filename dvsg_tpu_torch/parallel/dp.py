"""Batched chunk steps: a batch of clips through one device step per chunk.

The single-device part of the JAX package's ``parallel/dp.py``. The JAX
package maps the single-clip step over a leading clip axis with
``jax.vmap``; the offsets kernel is a ctypes launch, which
``torch.func.vmap`` cannot map, so here the clip axis is folded into the
frame axis instead (pipeline/stabilize.py):

* ``downscale_norm`` over the B·T frames;
* the per-clip model-resolution sequence (B, T+N−1, mh, mw, C);
* ``encode_frames`` over the B·(T+N−1) frames;
* feature windows gathered per clip, the head over the B·T windows;
* path smoothing over a leading clip axis (frame pairs never span clips);
* one launch of the offsets kernel over the B·T frames.

The mesh part (sharded steps and data-parallel training) is not ported yet.
"""

from __future__ import annotations

import functools

import torch

from dvsg_tpu_torch.config import StabilizeConfig
from dvsg_tpu_torch.pipeline.stabilize import (stabilize_chunk_impl,
                                               stabilize_chunk_lag_impl,
                                               stabilize_chunk_smooth_impl)


def _check(frames_u8: torch.Tensor, halos: torch.Tensor) -> None:
    if frames_u8.dim() != 5 or halos.dim() != 5 \
            or frames_u8.shape[0] != halos.shape[0]:
        raise ValueError(f"need (B, T, H, W, C) frames and (B, window-1, mh, "
                         f"mw, C) halos, got {tuple(frames_u8.shape)} and "
                         f"{tuple(halos.shape)}")


def _stabilize_chunk_batch(cfg: StabilizeConfig, model, frames_u8, halos):
    """The plain chunk step over a leading clip axis.

    frames_u8: (B, T, H, W, C) uint8; halos: (B, window-1, mh, mw, C) f32.
    Returns (out (B, T, H, W, C), new_halos, offsets (B, T, gh, gw, 2)).
    """
    _check(frames_u8, halos)
    return stabilize_chunk_impl(cfg, model, frames_u8, halos)


def _stabilize_chunk_batch_smooth(cfg: StabilizeConfig, model, frames_u8,
                                  halos, states):
    """Path-smoothed batched chunk step: per-clip (B, 4) EMA states (each
    clip's camera path is independent). Returns (out, new_halos,
    new_states, offsets)."""
    _check(frames_u8, halos)
    return stabilize_chunk_smooth_impl(cfg, model, frames_u8, halos, states)


def _stabilize_chunk_batch_lag(cfg: StabilizeConfig, model, frames_u8,
                               halos, carries):
    """Fixed-lag batched chunk step: the per-clip carries (D raw frames, D
    offset grids, measurement window; ``init_lag_carries``) ride the clip
    axis, and emission is shifted by D as in the single-clip lag step.
    Returns (out, new_halos, new_carries, offsets)."""
    _check(frames_u8, halos)
    out, new_halos, cf, co, cd, cc, offs = stabilize_chunk_lag_impl(
        cfg, model, frames_u8, halos, *carries)
    return out, new_halos, (cf, co, cd, cc), offs


def batch_step(cfg: StabilizeConfig):
    """The batched chunk step of ``cfg``'s mode, taking (model, frames,
    halos) and, for the smoothed and lag modes, the per-clip states or lag
    carries."""
    if cfg.path_smooth_lag > 0:
        return functools.partial(_stabilize_chunk_batch_lag, cfg)
    if cfg.path_smooth > 0:
        return functools.partial(_stabilize_chunk_batch_smooth, cfg)
    return functools.partial(_stabilize_chunk_batch, cfg)
