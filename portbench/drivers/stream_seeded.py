"""``stream.py``'s overlapped stream, ``correct`` and faults, for a
configuration with seeded weights and no checkpoint: the ``pwc`` arch
(PWC-Net as the motion estimator).

The weights are ``reference/pwc.py::init`` of the configuration's model
and the run's seed; the same tensors go to the program and to the
reference. The reference chunk is ``reference/stream_pwc.py``'s. Set-up,
the window, the kept chunks and ``mismatch_share`` are ``stream.py``'s.
Besides ``stream.py``'s two faults, ``sweep`` plants two in the pwc arch:
``feature_warp_skipped`` (every level warps by a zero flow) and
``context_skipped`` (level 2's flow without the context network's
refinement).
"""

from __future__ import annotations

import contextlib
import time

import torch

from portbench import harness
from portbench.reference import pwc, stream_pwc

# This driver's own instance of stream.py, whose reference is replaced
# below (the harness loads stream.py afresh for the cells that run it).
_stream = harness.load_module("drivers", "stream")

PWC_FAULTS = ("feature_warp_skipped", "context_skipped")
# Offsets at or beyond this share of max_offset count as saturated.
SATURATED = 0.95


def reference_u8(k: int, ring, params: dict, model: dict, device,
                 tf32: bool = False) -> torch.Tensor:
    """``stream.py::reference_u8`` with ``stream_pwc.chunk``."""
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        prev = (torch.from_numpy(ring[(k - 1) % len(ring)]).to(device)
                if k else None)
        out = stream_pwc.chunk(
            params, model, torch.from_numpy(ring[k % len(ring)]).to(device),
            prev)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return torch.round(out * 255.0).clamp(0, 255).to(torch.uint8)


_stream.reference_u8 = reference_u8


@contextlib.contextmanager
def planted(stab, fault):
    """A pwc fault planted in the stream's model for the block."""
    from dvsg_tpu_torch.models import motion_cnn
    if fault == "feature_warp_skipped":
        warp = motion_cnn.feature_warp
        motion_cnn.feature_warp = lambda x, f: warp(x, torch.zeros_like(f))
        try:
            yield
        finally:
            motion_cnn.feature_warp = warp
    elif fault == "context_skipped":
        hook = stab.model.dc_conv7.register_forward_hook(
            lambda mod, args, out: torch.zeros_like(out))
        try:
            yield
        finally:
            hook.remove()
    else:
        raise ValueError(f"unknown fault {fault!r}")


class Stream(_stream.Stream):
    """``stream.Stream`` on seeded weights, with the pwc faults."""

    def __init__(self, ctx: harness.Ctx):
        t = time.monotonic()
        from dvsg_tpu_torch.config import (StabilizeConfig,
                                           model_config_from_dict)
        from dvsg_tpu_torch.pipeline import overlap
        from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
        from dvsg_tpu_torch.utils.metrics import StageTimer
        self.overlap, self.StageTimer = overlap, StageTimer
        self.Stabilizer = Stabilizer
        ctx.part("import_program", time.monotonic() - t)

        self.ctx, self.dev = ctx, ctx.device
        traffic = ctx.spec.traffic
        harness.start_device(ctx)
        self.cfg = StabilizeConfig(
            model=model_config_from_dict(ctx.spec.config["model"]),
            chunk_frames=traffic["chunk_frames"],
            queue_depth=traffic["queue_depth"])
        self.load(ctx.seed)

    def load(self, seed: int) -> None:
        """The program's stream on the weights of ``seed``."""
        t = time.monotonic()
        self.params = pwc.init(self.ctx.spec.config["model"], seed)
        self.stab = self.Stabilizer(self.cfg, self.params, self.dev)
        self.ctx.part("weights", time.monotonic() - t)

    def window(self, ring, seconds, keep, fault=None, traces=None):
        if fault not in PWC_FAULTS:
            return super().window(ring, seconds, keep, fault, traces)
        with planted(self.stab, fault):
            return super().window(ring, seconds, keep, None, traces)

    def reference_params(self) -> dict:
        return {k: v.to(self.dev) for k, v in self.params.items()}


def run_rank(ctx: harness.Ctx) -> harness.Run:
    """``stream.py::run_rank`` on seeded weights."""
    s = Stream(ctx)
    spec, dev = ctx.spec, ctx.device
    ring = s.inputs(ctx.seed)
    s.warm(ring)
    traces = [] if ctx.trace else None
    setup_s = time.monotonic() - ctx.t_start
    reader, writer, timer, window_s = s.window(
        ring, ctx.seconds, _stream.sample(ctx.seed, _stream.CHECK_EVERY),
        ctx.fault, traces)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    params = s.reference_params()
    del s
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = _stream.compare(writer.kept, ring, params, spec.config["model"],
                             dev)
    n_done = len(writer.received)
    lat = [1e3 * (r - a) for a, r in zip(reader.accepted, writer.received)]
    return harness.Run(
        spec=spec, rank=ctx.rank, world=ctx.world, setup_s=setup_s,
        window_s=window_s,
        work={"frames": writer.frames, "chunks": n_done,
              "chunk_frames": ring.shape[1], "height": ring.shape[2],
              "width": ring.shape[3]},
        stamps={"latency_ms": lat}, stages=timer.summary(), checks=checks,
        attempted=reader.handed, failed=reader.handed - n_done,
        memory_peak_bytes=int(peak), trace=traces[0] if traces else None)


def saturated_share(kept: dict, ring, params: dict, model: dict,
                    device) -> float:
    """The share of the reference's offsets, over the kept chunks, at or
    beyond ``SATURATED`` times ``max_offset``."""
    hits = total = 0
    for k in kept:
        prev = (torch.from_numpy(ring[(k - 1) % len(ring)]).to(device)
                if k else None)
        offs = stream_pwc.offsets(
            params, model, torch.from_numpy(ring[k % len(ring)]).to(device),
            prev)
        hits += int((offs.abs() >= SATURATED * model["max_offset"]).sum())
        total += offs.numel()
    return hits / max(total, 1)


def sweep(ctx: harness.Ctx, seeds) -> list:
    """``stream.py::sweep`` with the pwc faults, on the weights of each
    seed; each record also gives the share of saturated offsets."""
    s = Stream(ctx)
    dev, model = ctx.device, ctx.spec.config["model"]
    out = []
    for i, seed in enumerate(seeds):
        if i:
            s.load(seed)
        params = s.reference_params()
        ring = s.inputs(seed)
        s.warm(ring)
        keep = _stream.sample(seed, _stream.SWEEP_CHECK_EVERY)
        rec = {"seed": seed}
        for fault in (None, "halo_unchanged", "answer_altered") + PWC_FAULTS:
            _, writer, _, _ = s.window(ring, _stream.SWEEP_SECONDS, keep,
                                       fault)
            rec[fault or "program"] = _stream.compare(writer.kept, ring,
                                                      params, model, dev)
            if fault is None:
                control = {k: reference_u8(k, ring, params, model, dev,
                                           tf32=True).cpu()
                           for k in writer.kept}
                rec["saturated_share"] = saturated_share(
                    writer.kept, ring, params, model, dev)
            rec["chunks_" + (fault or "program")] = len(writer.kept)
        rec["control"] = _stream.compare(control, ring, params, model, dev)
        out.append(rec)
    return out
