"""Temporal sharding of a single clip: the frame axis of each chunk over the
ranks of a mesh.

The model has no attention, so the "sequence" axis is time. Each rank
stabilizes T/n consecutive frames of every chunk; the only exchange is the
(window-1)-frame model-resolution halo each rank sends its right neighbour
(a ring of isend/irecv, the JAX package's ``ppermute``), and, with path
smoothing, one all-gather of the per-pair camera deltas and confidences.
Everything else (resize, CNN, offsets kernel) is local. The outputs are
byte-identical to the single-process pipeline.
"""

from __future__ import annotations

import numpy as np
import torch

from dvsg_tpu_torch.config import StabilizeConfig
from dvsg_tpu_torch.parallel import mesh as mesh_lib
from dvsg_tpu_torch.pipeline import pathsmooth
from dvsg_tpu_torch.pipeline.stabilize import (_warp, build_model,
                                               downscale_frames, fetch_frames,
                                               initial_halo,
                                               predict_chunk_offsets,
                                               put_frames)


def _local_chunk(cfg: StabilizeConfig, mesh: mesh_lib.Mesh, model,
                 frames_u8: torch.Tensor, chunk_halo: torch.Tensor,
                 smooth_state=None):
    """One rank's part of a chunk step.

    frames_u8: (T_local, H, W, C) this rank's frames of the chunk.
    chunk_halo: (window-1, mh, mw, C), the chunk-level carry, read on rank
      0 only; every other rank takes its left neighbour's tail.
    smooth_state: optional (4,) path-smoothing state, the same on every
      rank.
    Returns (stabilized local frames, the tail received from the left
    neighbour — on rank 0 the last rank's tail, i.e. the next chunk's
    halo), plus the new smoothing state when smoothing is on.
    """
    n = cfg.model.window
    t_local = frames_u8.shape[0]
    small = downscale_frames(cfg, frames_u8)
    tail = small[t_local - (n - 1):]
    prev_tail = mesh_lib.ring_shift(mesh, tail)
    prev = chunk_halo if mesh.rank == 0 else prev_tail
    seq = torch.cat([prev, small], dim=0)
    offsets = predict_chunk_offsets(cfg, model, seq, t_local)

    new_state = None
    if smooth_state is not None:
        # The EMA runs over time, but its inputs (per-pair deltas, (T, 4)
        # f32) are tiny: each rank measures its own pairs (the FFT part),
        # one all-gather assembles the chunk's delta sequence, and every
        # rank runs the same gating and scan, then takes its own rows. Rank
        # i's local entry m is global entry i·T_local + m, so rank 0 gives
        # all its entries and every later rank its last T_local.
        d_loc, c_loc = pathsmooth.measure(cfg, seq)        # (T_l+n-2, 4)
        gd = mesh_lib.all_gather(mesh, d_loc[None])
        gc = mesh_lib.all_gather(mesh, c_loc[None])
        gdeltas = torch.cat([gd[0]] + [gd[i, n - 2:]
                                       for i in range(1, mesh.size)])
        gconf = torch.cat([gc[0]] + [gc[i, n - 2:]
                                     for i in range(1, mesh.size)])
        e, new_state = pathsmooth.corrections_from_measured(
            cfg, gdeltas, gconf, t_local * mesh.size, smooth_state)
        rows = slice(mesh.rank * t_local, (mesh.rank + 1) * t_local)
        offsets = pathsmooth.apply_corrections(cfg, offsets, e[rows])

    out_u8 = _warp(cfg, frames_u8, offsets)
    if smooth_state is not None:
        return out_u8, prev_tail, new_state
    return out_u8, prev_tail


def make_temporal_chunk_fn(cfg: StabilizeConfig, mesh: mesh_lib.Mesh):
    """This rank's chunk step with the FRAME axis sharded over the mesh:
    fn(model, frames (T/n, H, W, C) uint8, halo) → (this rank's stabilized
    frames, the received tail) and, with cfg.path_smooth > 0, an extra
    (4,) state in and out. T must divide over the ranks; the lag mode is
    refused."""
    pathsmooth.lag_reject(cfg, "the temporal-sharded surface")
    if mesh.rank is None:
        raise ValueError("this process is not in the mesh")

    def fn(model, frames_u8, halo, *state):
        return _local_chunk(cfg, mesh, model, frames_u8, halo, *state)
    return fn


class TemporalShardedStabilizer:
    """Single-clip stabilization with the time axis of every chunk sharded
    over the mesh; every rank gets the whole clip back (one gather of the
    outputs per chunk)."""

    def __init__(self, cfg: StabilizeConfig, params: dict,
                 mesh: mesh_lib.Mesh):
        n_dev = mesh.size
        if cfg.chunk_frames % n_dev:
            raise ValueError(
                f"chunk_frames {cfg.chunk_frames} must divide over "
                f"{n_dev} devices")
        t_local = cfg.chunk_frames // n_dev
        if t_local < cfg.model.window - 1:
            # The halo exchange passes ONE left neighbour's tail of
            # window-1 frames; a shorter local shard cannot supply it.
            raise ValueError(
                f"chunk_frames/n_dev = {t_local} local frames is shorter "
                f"than the model's halo (window-1 = "
                f"{cfg.model.window - 1}); raise chunk_frames to at "
                f"least {(cfg.model.window - 1) * n_dev} for "
                f"{n_dev} devices")
        self.cfg = cfg
        self.mesh = mesh
        self._fn = make_temporal_chunk_fn(cfg, mesh)
        self.model = build_model(cfg.model, params, mesh.device)

    @torch.inference_mode()
    def stabilize_clip(self, frames_u8: np.ndarray) -> np.ndarray:
        """frames_u8 (T, H, W, C) uint8 → stabilized, on every rank."""
        total = frames_u8.shape[0]
        if total == 0:
            return frames_u8
        cfg, mesh, dev = self.cfg, self.mesh, self.mesh.device
        t_chunk = cfg.chunk_frames
        mine = mesh.shard(t_chunk, "chunk_frames")
        halo = initial_halo(cfg, frames_u8[0], dev)
        state = ((pathsmooth.initial_state(dev),) if cfg.path_smooth > 0
                 else ())
        outs = []
        for start in range(0, total, t_chunk):
            chunk = frames_u8[start:start + t_chunk]
            n_valid = chunk.shape[0]
            if n_valid < t_chunk:
                pad = np.repeat(chunk[-1:], t_chunk - n_valid, axis=0)
                chunk = np.concatenate([chunk, pad], axis=0)
            out, halo, *state = self._fn(
                self.model, put_frames(chunk[mine], dev), halo, *state)
            outs.append(fetch_frames(
                mesh_lib.all_gather(mesh, out)[:n_valid]))
        return np.concatenate(outs, axis=0)
