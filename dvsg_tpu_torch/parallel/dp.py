"""Batched chunk steps, per-clip data parallelism and data-parallel
training.

The JAX package maps the single-clip step over a leading clip axis with
``jax.vmap``; the offsets kernel is a ctypes launch, which
``torch.func.vmap`` cannot map, so here the clip axis is folded into the
frame axis instead (pipeline/stabilize.py):

* ``downscale_norm`` over the B·T frames;
* the per-clip model-resolution sequence (B, T+N−1, mh, mw, C);
* ``encode_frames`` over the B·(T+N−1) frames;
* feature windows gathered per clip, the head over the B·T windows;
* path smoothing over a leading clip axis (frame pairs never span clips);
* one launch of the offsets kernel over the B·T frames.

Over a mesh (parallel/mesh.py: one process per card), every rank runs that
batched step on its own B/n clips, and the outputs are gathered once per
clip batch: clips are independent, so the steps make no collective. Data-
parallel training draws the whole batch on every rank, renders and
differentiates the rank's B/n samples, and sums the gradients with one
all-reduce before every rank takes the same AdamW step.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dvsg_tpu_torch.config import StabilizeConfig, TrainConfig
from dvsg_tpu_torch.parallel import mesh as mesh_lib
from dvsg_tpu_torch.pipeline import pathsmooth
from dvsg_tpu_torch.pipeline.stabilize import (build_model,
                                               drive_chunked_batch,
                                               drive_chunked_batch_lag,
                                               stabilize_chunk_impl,
                                               stabilize_chunk_lag_impl,
                                               stabilize_chunk_smooth_impl)
from dvsg_tpu_torch.train import loop as train_loop


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


# ---------------------------------------------------------------------------
# Sharded batched stabilization (a batch of clips, one shard per rank)
# ---------------------------------------------------------------------------

def make_sharded_chunk_fn(cfg: StabilizeConfig, mesh: mesh_lib.Mesh):
    """This rank's part of the clip-sharded chunk step: the batched step of
    ``cfg``'s mode (``batch_step``) over the rank's B/n clips. With
    cfg.path_smooth > 0 it takes and returns the (B/n, 4) per-clip
    smoothing states (``pathsmooth.thread_batch_state`` adapts it to the
    3-argument drive loops); with cfg.path_smooth_lag > 0 it is the lag
    step for ``drive_chunked_batch_lag``. It makes no collective."""
    if mesh.rank is None:
        raise ValueError("this process is not in the mesh")
    return batch_step(cfg)


class ShardedClipStabilizer:
    """Stabilize a batch of equal-length clips, B/n clips on each rank of
    the mesh; every rank gets the whole batch back."""

    def __init__(self, cfg: StabilizeConfig, params: dict,
                 mesh: mesh_lib.Mesh):
        self.cfg = cfg
        self.mesh = mesh
        self._fn = make_sharded_chunk_fn(cfg, mesh)
        self.model = build_model(cfg.model, params, mesh.device)

    def stabilize_clips(self, clips_u8: np.ndarray) -> np.ndarray:
        """clips_u8 (B, T_total, H, W, C) uint8 → the same shape,
        stabilized, on every rank (one gather of the outputs)."""
        mine = clips_u8[self.mesh.shard(clips_u8.shape[0], "clip batch")]
        if self.cfg.path_smooth_lag > 0:
            out = drive_chunked_batch_lag(self._fn, self.model, self.cfg,
                                          mine)
        else:
            fn = self._fn
            if self.cfg.path_smooth > 0:
                fn = pathsmooth.thread_batch_state(fn, len(mine),
                                                   self.mesh.device)
            out = drive_chunked_batch(fn, self.model, self.cfg, mine)
        return mesh_lib.all_gather_rows(self.mesh, out)


# ---------------------------------------------------------------------------
# Data-parallel training step
# ---------------------------------------------------------------------------

def make_dp_train_step(cfg: TrainConfig, mesh: mesh_lib.Mesh, bank=None):
    """DP train step: every rank holds the whole model and optimizer, and
    renders and differentiates its own B/n samples of the batch.

    Returns (step_fn, shard_batch). ``shard_batch(generator)`` draws the
    whole batch from the step's generator (``train.loop.step_generator(
    seed, step)``) on every rank, as the single-device step draws it, and
    returns this rank's rows of the draws (stills, paths, gains).
    ``step_fn(state, rows)`` updates ``state`` in place and returns the
    full batch's loss terms. Every loss term is a mean over the batch, so
    each rank weights its local loss by its share of the batch and one
    all-reduce (sum) of the gradients gives every rank the full batch's
    gradient; every rank then takes the same AdamW step.

    ``bank`` (train/data.py) is a real-footage image bank; every rank holds
    all of it and draws its stills from it.
    """
    n = mesh.size
    if cfg.batch_size % n:
        raise ValueError(f"batch_size {cfg.batch_size} must divide over "
                         f"{n} devices")
    rows = mesh.shard(cfg.batch_size)
    weight = 1.0 / n
    if bank is not None:        # upload once, reuse per step
        bank = torch.as_tensor(bank, dtype=torch.float32).to(mesh.device)

    def shard_batch(generator):
        draws = train_loop.draw_batch(generator, cfg, bank, mesh.device)
        return tuple(d[rows] for d in draws)

    def step_fn(state: train_loop.TrainState, local_draws) -> dict:
        dev = next(state.model.parameters()).device
        state.optimizer.zero_grad(set_to_none=True)
        batch = train_loop.render_batch(*(d.to(dev) for d in local_draws),
                                        cfg)
        total, aux = train_loop.loss_from_batch(state.model, batch, cfg)
        if n > 1:
            total = total * weight
        total.backward()
        params = [p for p in state.model.parameters() if p.grad is not None]
        if mesh.group is not None:
            flat = torch.cat([p.grad.reshape(-1) for p in params])
            flat = mesh_lib.all_reduce_sum(mesh, flat)
            i = 0
            for p in params:
                k = p.grad.numel()
                p.grad.copy_(flat[i:i + k].view_as(p.grad))
                i += k
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        names = sorted(aux)
        terms = torch.stack([aux[k].detach() for k in names])
        if n > 1:
            terms = mesh_lib.all_reduce_sum(mesh, terms * weight)
        return dict(zip(names, terms.unbind()))

    return step_fn, shard_batch


def replicate_state(state: train_loop.TrainState,
                    mesh: mesh_lib.Mesh) -> train_loop.TrainState:
    """Give every rank rank 0's parameters, buffers and optimizer moments
    (a broadcast from rank 0); returns ``state``."""
    for t in state.model.state_dict().values():
        mesh_lib.broadcast_(mesh, t)
    for per_param in state.optimizer.state.values():
        for v in per_param.values():
            if torch.is_tensor(v):
                mesh_lib.broadcast_(mesh, v)
    return state
