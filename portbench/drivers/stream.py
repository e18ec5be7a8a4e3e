"""The overlapped stream (``pipeline/overlap.py::
stabilize_stream_overlapped``) on one card, fed from a ring of chunks.

Set-up makes one seeded shaky clip of ``ring_chunks`` chunks on the card,
keeps it on the host, and warms the stream up on a few of its chunks.
In the window a reader thread of the stream is handed the ring's chunks
in turn (chunk k is ring chunk k mod R: one long clip that starts over)
until ``seconds`` have passed; the writer is a sink that stamps each
chunk's arrival and keeps a sample of the chunks, drawn from the seed.
The window ends when the stream has written every chunk it was handed.

A chunk's latency runs from the stream accepting it (its reader thread
comes back for the next chunk once the chunk is in the stream's queue)
to the writer receiving its frames. The loop is closed, so the queue is
full and the latency is about the queue's length in chunk periods.

``correct`` compares every kept chunk with the plain reference
(``portbench/reference/stream.py``), which works the chunk out again from
the checkpoint file and the chunk's frames and its predecessor's:
``mismatch_share`` is the largest share of bytes in one frame that differ
from the reference rounded.
"""

from __future__ import annotations

import contextlib
import os
import random
import time

import numpy as np
import torch

from portbench import generate, harness, tracing

WARMUP_CHUNKS = 6
# A run checks chunks 0, 1 and one in CHECK_EVERY; the sweep's shorter
# windows check one in SWEEP_CHECK_EVERY, about as many chunks.
CHECK_EVERY = 80
SWEEP_SECONDS = 3.0
SWEEP_CHECK_EVERY = 8


class RingReader:
    """Hands out the ring's chunks until the deadline, stamping when the
    stream accepted each: when its reader thread asks for the next."""

    def __init__(self, ring: np.ndarray, seconds: float,
                 max_chunks: int = 0):
        self.ring, self.seconds, self.max_chunks = ring, seconds, max_chunks
        self.handed = 0
        self.accepted: list = []
        self.t0 = None

    def read_batch(self, n: int) -> np.ndarray:
        now = time.perf_counter()
        k = self.handed
        if len(self.accepted) < k:
            self.accepted.append(now)
        if (self.max_chunks and k >= self.max_chunks) or (
                self.seconds and now - self.t0 >= self.seconds):
            return self.ring[0, :0]
        self.handed += 1
        return self.ring[k % len(self.ring)]


class SinkWriter:
    """Stamps each chunk's arrival and keeps a copy of the chunks in
    ``keep``."""

    def __init__(self, keep=lambda k: False):
        self.keep = keep
        self.received: list = []
        self.kept: dict = {}
        self.frames = 0

    def write_batch(self, frames: np.ndarray) -> None:
        k = len(self.received)
        self.received.append(time.perf_counter())
        if self.keep(k):
            self.kept[k] = frames.copy()
        self.frames += len(frames)


def _plant(stab, fault):
    """Break the stream's chunk step underneath (faults the check must
    catch)."""
    step = stab._chunk
    if fault == "halo_unchanged":
        @torch.inference_mode()
        def broken(dev_chunk, halo):
            out, _, offs = step(dev_chunk, halo)
            return out, halo, offs
    elif fault == "answer_altered":
        @torch.inference_mode()
        def broken(dev_chunk, halo):
            out, new_halo, offs = step(dev_chunk, halo)
            out = out.clone()
            out[0] = dev_chunk[0]
            return out, new_halo, offs
    else:
        raise ValueError(f"unknown fault {fault!r}")
    stab._chunk = broken


def sample(seed: int, every: int):
    """The chunks whose output is checked: the first two (the stream's
    start) and one in every ``every``, at an offset drawn from the seed."""
    r = random.Random(seed).randrange(every)
    return lambda k: k < 2 or k % every == r


def reference_u8(k: int, ring: np.ndarray, params: dict, model: dict,
                 device, tf32: bool = False) -> torch.Tensor:
    """The reference's stabilized chunk k of the stream, rounded to
    uint8 (computed with TF32 on for the control)."""
    from portbench.reference import stream as ref
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        prev = (torch.from_numpy(ring[(k - 1) % len(ring)]).to(device)
                if k else None)
        out = ref.chunk(params, model,
                        torch.from_numpy(ring[k % len(ring)]).to(device),
                        prev)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return torch.round(out * 255.0).clamp(0, 255).to(torch.uint8)


def compare(kept: dict, ring: np.ndarray, params: dict, model: dict,
            device) -> dict:
    """The numbers compared, over the kept chunks (uint8 arrays or
    tensors by chunk index) against the reference."""
    worst = 0.0
    for k, got in sorted(kept.items()):
        want = reference_u8(k, ring, params, model, device)
        differ = torch.as_tensor(got).to(device) != want
        worst = max(worst, float(differ.flatten(1).float().mean(dim=1).max()))
    return {"mismatch_share": worst}


def reference_params(spec, device) -> dict:
    from portbench.reference import cnn
    params, _ = cnn.load_npz(os.path.join(harness.ROOT,
                                          spec.config["checkpoint"]))
    return {k: v.to(device) for k, v in params.items()}


class Stream:
    """The program's stream on this card, built once."""

    def __init__(self, ctx: harness.Ctx):
        t = time.monotonic()
        from dvsg_tpu_torch.config import (StabilizeConfig,
                                           model_config_from_dict)
        from dvsg_tpu_torch.pipeline import overlap
        from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
        from dvsg_tpu_torch.utils.checkpoint import load_npz
        from dvsg_tpu_torch.utils.metrics import StageTimer
        self.overlap, self.StageTimer = overlap, StageTimer
        ctx.part("import_program", time.monotonic() - t)

        self.ctx, self.dev = ctx, ctx.device
        spec, traffic = ctx.spec, ctx.spec.traffic
        harness.start_device(ctx)

        t = time.monotonic()
        params, mcfg = load_npz(os.path.join(harness.ROOT,
                                             spec.config["checkpoint"]))
        if mcfg != model_config_from_dict(spec.config["model"]):
            raise ValueError(f"{spec.config['checkpoint']} holds {mcfg}, not "
                             f"the configuration's {spec.config['model']}")
        self.cfg = StabilizeConfig(model=mcfg,
                                   chunk_frames=traffic["chunk_frames"],
                                   queue_depth=traffic["queue_depth"])
        self.stab = Stabilizer(self.cfg, params, self.dev)
        ctx.part("weights", time.monotonic() - t)

    def inputs(self, seed: int) -> np.ndarray:
        """The ring of chunks (R, T, H, W, C) uint8 on the host."""
        t = time.monotonic()
        traffic, t_chunk = self.ctx.spec.traffic, self.cfg.chunk_frames
        n = traffic["ring_chunks"]
        clip = generate.shaky_clip(traffic, seed, self.dev, n * t_chunk)
        ring = clip.cpu().numpy().reshape(n, t_chunk, *clip.shape[1:])
        self.ctx.part("inputs", time.monotonic() - t)
        return ring

    def warm(self, ring: np.ndarray) -> None:
        t = time.monotonic()
        self.overlap.stabilize_stream_overlapped(
            self.stab,
            RingReader(ring, 0, WARMUP_CHUNKS),
            SinkWriter())
        harness.sync(self.dev)
        self.ctx.part("warmup", time.monotonic() - t)

    def window(self, ring: np.ndarray, seconds: float, keep, fault=None,
               traces=None):
        """Stream the ring for ``seconds``: (reader, writer, timer,
        window seconds)."""
        reader, writer = RingReader(ring, seconds), SinkWriter(keep)
        timer = self.StageTimer()
        if fault:
            _plant(self.stab, fault)
        try:
            with (tracing.capture(self.dev, traces) if traces is not None
                  else contextlib.nullcontext()):
                t0 = time.perf_counter()
                reader.t0 = t0
                self.overlap.stabilize_stream_overlapped(self.stab, reader,
                                                         writer, timer)
                harness.sync(self.dev)
                window_s = time.perf_counter() - t0
        finally:
            self.stab.__dict__.pop("_chunk", None)
        return reader, writer, timer, window_s


def run_rank(ctx: harness.Ctx) -> harness.Run:
    s = Stream(ctx)
    spec, dev = ctx.spec, ctx.device
    ring = s.inputs(ctx.seed)
    s.warm(ring)
    traces = [] if ctx.trace else None
    setup_s = time.monotonic() - ctx.t_start
    reader, writer, timer, window_s = s.window(
        ring, ctx.seconds, sample(ctx.seed, CHECK_EVERY),
        ctx.fault, traces)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del s
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare(writer.kept, ring, reference_params(spec, dev),
                     spec.config["model"], dev)
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


def sweep(ctx: harness.Ctx, seeds) -> list:
    """Per seed, the numbers compared for the program (a short window at
    the cell's load, checked more densely so that it compares as many
    chunks as a run does), for the control (the reference with TF32 on,
    in the program's place, on the same chunks) and for each fault
    planted in the program."""
    s = Stream(ctx)
    dev, model = ctx.device, ctx.spec.config["model"]
    params = reference_params(ctx.spec, dev)
    out = []
    for i, seed in enumerate(seeds):
        ring = s.inputs(seed)
        if i == 0:
            s.warm(ring)
        keep = sample(seed, SWEEP_CHECK_EVERY)
        rec = {"seed": seed}
        for fault in (None, "halo_unchanged", "answer_altered"):
            _, writer, _, _ = s.window(ring, SWEEP_SECONDS, keep, fault)
            rec[fault or "program"] = compare(writer.kept, ring, params,
                                              model, dev)
            if fault is None:
                control = {k: reference_u8(k, ring, params, model, dev,
                                           tf32=True).cpu()
                           for k in writer.kept}
            rec["chunks_" + (fault or "program")] = len(writer.kept)
        rec["control"] = compare(control, ring, params, model, dev)
        out.append(rec)
    return out
