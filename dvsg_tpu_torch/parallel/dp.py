"""Per-clip data parallelism and data-parallel training.

The JAX package maps the single-clip step over a leading clip axis with
``jax.vmap``; the offsets kernel is a ctypes launch, which
``torch.func.vmap`` cannot map, so the port's batched chunk step (a
``ChunkStep`` with ``batched=True``, pipeline/stabilize.py) folds the clip
axis into the frame axis instead:

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

import numpy as np
import torch

from dvsg_tpu_torch.config import StabilizeConfig, TrainConfig
from dvsg_tpu_torch.parallel import mesh as mesh_lib
from dvsg_tpu_torch.pipeline.stabilize import (ChunkStep, build_model,
                                               drive_chunked_batch)
from dvsg_tpu_torch.train import loop as train_loop


# ---------------------------------------------------------------------------
# Sharded batched stabilization (a batch of clips, one shard per rank)
# ---------------------------------------------------------------------------

class ShardedClipStabilizer:
    """Stabilize a batch of equal-length clips, B/n clips on each rank of
    the mesh; every rank gets the whole batch back. Each rank runs the
    batched ``ChunkStep`` over its B/n clips; the steps make no
    collective."""

    def __init__(self, cfg: StabilizeConfig, params: dict,
                 mesh: mesh_lib.Mesh):
        if mesh.rank is None:
            raise ValueError("this process is not in the mesh")
        self.cfg = cfg
        self.mesh = mesh
        self.model = build_model(cfg.model, params, mesh.device)

    def stabilize_clips(self, clips_u8: np.ndarray) -> np.ndarray:
        """clips_u8 (B, T_total, H, W, C) uint8 → the same shape,
        stabilized, on every rank (one gather of the outputs)."""
        mine = clips_u8[self.mesh.shard(clips_u8.shape[0], "clip batch")]
        out = drive_chunked_batch(
            ChunkStep(self.cfg, self.model, batched=True), mine)
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
