"""Batched multi-clip streaming: N videos in → N stabilized videos out.

A batch of clips goes through one batched chunk step per chunk
(pipeline/stabilize.py's ``ChunkStep``). Host decode runs in one thread
per clip, encode likewise, with bounded queues, so host I/O overlaps the
device steps; each chunk's output is copied to the host behind the next
chunk's compute.

Clips of different lengths are handled by replicate-padding finished clips
until the longest clip ends (their outputs are dropped). Clips must share
one resolution: ``stabilize_multi`` raises on a mixed-resolution batch.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from dvsg_tpu_torch import resolve_device
from dvsg_tpu_torch.config import StabilizeConfig
from dvsg_tpu_torch.parallel import mesh as mesh_lib
from dvsg_tpu_torch.pipeline import pathsmooth
from dvsg_tpu_torch.pipeline.stabilize import (BehindFetch, ChunkStep,
                                               build_model, initial_halo,
                                               put_frames)
from dvsg_tpu_torch.utils.metrics import StageTimer

_SENTINEL = None


@dataclasses.dataclass
class MultiClipResult:
    """Per-clip outcome of a batch run.

    ``frames_written[i]`` counts frames flushed to writer i; for a failed
    clip it is the resume point (frame-directory outputs restart there).
    ``errors[i]`` is the exception that ended clip i's decode or encode, or
    None; a failed clip stops consuming device output, and the rest of the
    batch runs to completion. ``coverage_fallback_chunks`` is all zeros:
    the CUDA gather has no coverage band (kept for the reporting surface).
    """

    frames_written: List[int]
    errors: List[Optional[Exception]]
    coverage_fallback_chunks: Optional[List[int]] = None

    @property
    def failed_clips(self) -> List[int]:
        return [i for i, e in enumerate(self.errors) if e is not None]

    @property
    def ok(self) -> bool:
        return not self.failed_clips


def _decode_worker(reader, chunk, out_q, errs, idx, stop):
    # ``stop`` is this clip's abandon signal (its encoder failed, or the
    # device step died): it bounds how much a worker decodes after the main
    # loop stopped consuming.
    try:
        while not stop.is_set():
            batch = reader.read_batch(chunk)
            out_q.put(batch)
            if batch.shape[0] < chunk:
                break
    except Exception as e:
        errs[idx] = e
        out_q.put(np.zeros((0, reader.height, reader.width, 3), np.uint8))


def _encode_worker(writer, in_q, errs, written, idx):
    # ``written[idx]`` counts frames actually written, raised only after a
    # batch lands: the main loop may be chunks ahead of the writer, and an
    # enqueue-side count would overstate the resume point. A batch that
    # raises mid-write is not counted (undercounting re-writes frames on
    # resume; overcounting would skip them).
    try:
        while True:
            item = in_q.get()
            if item is _SENTINEL:
                break
            writer.write_batch(item)
            written[idx] += item.shape[0]
    except Exception as e:
        errs[idx] = e
        while in_q.get() is not _SENTINEL:
            pass


def stabilize_multi(cfg: StabilizeConfig, params: dict,
                    readers: Sequence, writers: Sequence, mesh=None,
                    timer: Optional[StageTimer] = None,
                    device="cuda") -> MultiClipResult:
    """Stabilize a batch of clips concurrently on ``device``.

    Readers need ``read_batch(n)`` and ``height``/``width``, writers
    ``write_batch(frames)`` (utils/video_io.py). Fault isolation is per
    clip: a clip whose reader or writer throws mid-stream is marked failed
    (its partial output and written-frame count are kept as the resume
    point) and the other clips run to completion. Only a failure of every
    clip raises.

    ``mesh`` (parallel/mesh.py): per-clip data parallelism. The clip count
    must divide over its ranks; each rank decodes, stabilizes and writes
    its own contiguous N/n clips on the mesh's device (``device`` is not
    read; the other ranks' readers and writers are not touched), and every
    rank gets the whole batch's ``MultiClipResult``.
    """
    timer = timer or StageTimer()
    n = len(readers)
    if n != len(writers):
        raise ValueError(f"{n} readers but {len(writers)} writers")
    pathsmooth.lag_reject(cfg, "the multi-clip batch driver")
    h, w = readers[0].height, readers[0].width
    for r in readers:
        if (r.height, r.width) != (h, w):
            raise ValueError("all clips must share one resolution; got "
                             f"{(r.height, r.width)} vs {(h, w)}")
    if mesh is None:
        result = _stabilize_local(cfg, params, readers, writers, timer,
                                  resolve_device(device))
    else:
        if n % mesh.size:
            # Before any worker thread starts.
            raise ValueError(
                f"clip count {n} must be divisible by the mesh's "
                f"{mesh.size} devices for per-clip data parallelism")
        mine = mesh.shard(n, "clip count")
        local = _stabilize_local(cfg, params, readers[mine], writers[mine],
                                 timer, mesh.device)
        parts = mesh_lib.all_gather_object(mesh, local)
        result = MultiClipResult(
            [c for p in parts for c in p.frames_written],
            [e for p in parts for e in p.errors],
            [c for p in parts for c in p.coverage_fallback_chunks])
    if len(result.failed_clips) == n:
        raise result.errors[0]
    return result


def _stabilize_local(cfg: StabilizeConfig, params: dict, readers: Sequence,
                     writers: Sequence, timer: StageTimer,
                     dev: torch.device) -> MultiClipResult:
    """``stabilize_multi``'s work on one device, without its final raise."""
    n = len(readers)
    t_chunk = cfg.chunk_frames
    h, w = readers[0].height, readers[0].width
    step = ChunkStep(cfg, build_model(cfg.model, params, dev), batched=True)

    # A decode error is acted on only when its (final) empty batch
    # arrives, so every frame decoded before it is still stabilized and
    # flushed: the written count is the resume point. An encode error stops
    # the clip at once (its output can no longer be consumed).
    dec_errors: List[Optional[Exception]] = [None] * n
    enc_errors: List[Optional[Exception]] = [None] * n
    dec_qs = [queue.Queue(maxsize=cfg.queue_depth) for _ in range(n)]
    enc_qs = [queue.Queue(maxsize=cfg.queue_depth) for _ in range(n)]
    written = [0] * n           # frames on disk, owned by encode workers
    threads = []
    dec_threads = []
    dec_stops = [threading.Event() for _ in range(n)]
    for i in range(n):
        t = threading.Thread(target=_decode_worker,
                             args=(readers[i], t_chunk, dec_qs[i],
                                   dec_errors, i, dec_stops[i]),
                             daemon=True)
        t.start()
        threads.append(t)
        dec_threads.append(t)
        t = threading.Thread(target=_encode_worker,
                             args=(writers[i], enc_qs[i], enc_errors,
                                   written, i),
                             daemon=True)
        t.start()
        threads.append(t)

    def _drain_decode(i):
        # Stop a failed clip's decode worker and drain its bounded queue,
        # so the worker cannot block on put() forever.
        dec_stops[i].set()

        def drain():
            while dec_threads[i].is_alive() or not dec_qs[i].empty():
                try:
                    dec_qs[i].get(timeout=0.1)
                except queue.Empty:
                    pass
        t = threading.Thread(target=drain, daemon=True)
        t.start()
        threads.append(t)

    done = [False] * n
    last = [None] * n           # last frame of each clip, for padding
    try:
        with torch.inference_mode():
            _run_main_loop(t_chunk, n, h, w, step, cfg, dev, timer,
                           dec_qs, enc_qs, dec_errors, enc_errors, done,
                           last, _drain_decode)
    except BaseException:
        # The device step (or a fetch) died: stop and drain the decode
        # workers before the exception escapes, so the caller's
        # writer.close() cannot race in-flight writes.
        for i in range(n):
            if not done[i]:
                _drain_decode(i)
        raise
    finally:
        for q in enc_qs:
            q.put(_SENTINEL)
        # Join without a timeout: the decoders have ended (their final
        # batch was consumed, or the stop and drain above), and the
        # sentinel ends each encoder once its queue is written out.
        for t in threads:
            t.join()
    merged = [d if d is not None else e
              for d, e in zip(dec_errors, enc_errors)]
    return MultiClipResult(written, merged, [0] * n)


def _run_main_loop(t_chunk, n, h, w, step, cfg, dev, timer, dec_qs,
                   enc_qs, dec_errors, enc_errors, done, last,
                   _drain_decode) -> None:
    halos = None
    pending = None      # (copy handle, valid list) of the previous chunk
    blank = np.zeros((t_chunk, h, w, 3), np.uint8)
    fetch = BehindFetch(dev)

    def flush(p):
        handle, valid = p
        with timer.stage("d2h"):
            host = fetch.finish(handle)
        for i in range(n):
            # A clip whose encoder failed stops consuming output; its
            # encode worker owns written[i], the resume point.
            if valid[i] > 0 and enc_errors[i] is None:
                enc_qs[i].put(host[i, :valid[i]])

    while not all(done):
        chunks, valid = [], []
        with timer.stage("decode_wait"):
            for i in range(n):
                if not done[i] and enc_errors[i] is not None:
                    done[i] = True   # encoder died: stop feeding the clip
                    _drain_decode(i)
                if done[i]:
                    chunks.append(blank if last[i] is None else np.repeat(
                        last[i][None], t_chunk, axis=0))
                    valid.append(0)
                    continue
                c = dec_qs[i].get()
                v = c.shape[0]
                if v == 0 and dec_errors[i] is not None:
                    # The decode worker's final (error) batch: every good
                    # batch before it has been processed.
                    done[i] = True
                    chunks.append(blank if last[i] is None else np.repeat(
                        last[i][None], t_chunk, axis=0))
                    valid.append(0)
                    continue
                if v == 0 and last[i] is None:
                    dec_errors[i] = ValueError(f"clip {i} is empty")
                    done[i] = True
                    chunks.append(blank)
                    valid.append(0)
                    continue
                if v < t_chunk:
                    done[i] = True
                if v > 0:
                    last[i] = c[-1]
                    if v < t_chunk:
                        pad = np.repeat(c[-1:], t_chunk - v, axis=0)
                        c = np.concatenate([c, pad], axis=0)
                else:
                    c = np.repeat(last[i][None], t_chunk, axis=0)
                chunks.append(c)
                valid.append(v)
        if all(done) and not any(valid):
            break
        if halos is None:
            halos = torch.stack([initial_halo(cfg, chunks[i][0], dev)
                                 for i in range(n)])
        with timer.stage("stack"):
            batch = np.stack(chunks)
        with timer.stage("dispatch"):
            out, halos, _ = step(put_frames(batch, dev), halos)
        if pending is not None:
            flush(pending)
        with timer.stage("d2h"):       # the pinned buffer, the copy queued
            pending = (fetch.start(out), list(valid))
    if pending is not None:
        flush(pending)
