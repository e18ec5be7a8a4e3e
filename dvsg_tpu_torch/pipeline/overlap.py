"""Overlapped host ↔ device streaming loop.

A three-stage pipeline, so that decode(k+1), compute(k) and encode(k−1)
run at once:

  decode thread → bounded queue → device loop → bounded queue → encode
  thread

The device loop queues chunk k's step on the card, then fetches chunk k−1,
whose step is done or about to be, while chunk k computes. PyTorch's
``.cpu()`` waits for all the work queued on the stream, chunk k included,
so the loop does the copies itself:

* uploads go from a ring of ``queue_depth`` pinned host buffers with
  ``non_blocking=True``; a buffer is filled again only after the event
  recorded behind its last upload has completed;
* after each chunk's step an event is recorded; the previous chunk's
  output is copied into a pinned host buffer on a side stream that waits
  on that event (``record_stream`` tells the allocator the side stream
  uses the tensor), and the loop waits on that copy's event alone;
* the ``queue_depth`` pinned output buffers go round between the loop and
  the encode thread, which hands each back once its frames are written.

On a CPU device the same loop copies synchronously into plain buffers. The
output is byte-identical to ``Stabilizer.stabilize_stream``: the same chunk
steps run on the same data in the same order. The writer's
``write_batch`` must be done with the array it is given when it returns
(its buffer is reused).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np
import torch

from dvsg_tpu_torch.pipeline import pathsmooth
from dvsg_tpu_torch.pipeline.stabilize import Stabilizer, put_frames
from dvsg_tpu_torch.utils.metrics import StageTimer

_SENTINEL = None


def _decode_worker(reader, chunk_frames: int, out_q: "queue.Queue",
                   err: list, timer: StageTimer) -> None:
    try:
        while True:
            with timer.stage("decode"):
                chunk = reader.read_batch(chunk_frames)
            if chunk.shape[0] == 0:
                break
            out_q.put(chunk)
            if chunk.shape[0] < chunk_frames:
                break
    except Exception as e:  # surface decode errors to the main thread
        err.append(e)
    finally:
        out_q.put(_SENTINEL)


def _encode_worker(writer, in_q: "queue.Queue", free_q: "queue.Queue",
                   err: list, timer: StageTimer) -> None:
    """Write each (slot, frames) item and hand its slot back; after a
    failure keep draining (and freeing slots), so no producer blocks on a
    dead consumer."""
    while True:
        item = in_q.get()
        if item is _SENTINEL:
            return
        slot, frames = item
        if not err:
            try:
                with timer.stage("encode"):
                    writer.write_batch(frames)
            except Exception as e:
                err.append(e)
        free_q.put(slot)


def stabilize_stream_overlapped(stab: Stabilizer, reader, writer,
                                timer: Optional[StageTimer] = None) -> int:
    """Stream with decode/compute/encode overlap; returns frames written.

    ``reader``/``writer`` as for ``Stabilizer.stabilize_stream`` (no
    resume). Stages timed on the device loop: ``decode_wait``, ``h2d``
    (staging and the upload's enqueue), ``dispatch`` (queuing the chunk
    step), ``d2h`` (waiting for the previous chunk and its copy) and
    ``encode_wait`` (waiting for a free output buffer); on the worker
    threads, ``decode`` (each ``read_batch``, the one that finds the end
    included) and ``encode`` (each ``write_batch``): their busy time.
    """
    timer = timer or StageTimer()
    pathsmooth.lag_reject(stab.cfg, "the overlapped stream loop "
                          "(use the sync stream for lag runs)")
    cfg = stab.cfg
    t_chunk, depth = cfg.chunk_frames, cfg.queue_depth
    dev = stab.device
    cuda = dev.type == "cuda"

    decode_q: "queue.Queue" = queue.Queue(maxsize=depth)
    encode_q: "queue.Queue" = queue.Queue(maxsize=depth)
    free_q: "queue.Queue" = queue.Queue()
    errors: list = []
    dec = threading.Thread(target=_decode_worker,
                           args=(reader, t_chunk, decode_q, errors, timer),
                           daemon=True)
    enc = threading.Thread(target=_encode_worker,
                           args=(writer, encode_q, free_q, errors, timer),
                           daemon=True)
    dec.start()
    enc.start()

    side = torch.cuda.Stream(dev) if cuda else None
    staging, staged, host = [], [], []   # rings, made at the first chunk
    stab.begin_stream()   # fresh per-stream state (path-smoothing EMA)
    halo = None
    written = 0
    n_chunks = 0
    pending = None  # (device output, its step's event, n_valid)

    def upload(chunk: np.ndarray) -> torch.Tensor:
        if not cuda:
            return put_frames(chunk, dev)
        slot = n_chunks % depth
        if staged[slot] is not None:
            staged[slot].synchronize()      # its last upload is done
        staging[slot].numpy()[...] = chunk
        dev_chunk = staging[slot].to(dev, non_blocking=True)
        staged[slot] = torch.cuda.Event()
        staged[slot].record(torch.cuda.current_stream(dev))
        return dev_chunk

    def fetch(p) -> None:
        nonlocal written
        out_dev, done, n_valid = p
        with timer.stage("encode_wait"):
            slot = free_q.get()
        dst = host[slot][:n_valid]
        with timer.stage("d2h"):
            if cuda:
                side.wait_event(done)
                with torch.cuda.stream(side):
                    dst.copy_(out_dev[:n_valid], non_blocking=True)
                    copied = torch.cuda.Event()
                    copied.record(side)
                out_dev.record_stream(side)
                copied.synchronize()
            else:
                dst.copy_(out_dev[:n_valid])
        encode_q.put((slot, dst.numpy()))
        written += n_valid

    def drain_decode() -> None:
        # Unblock the decode worker (it may be parked on a full queue) and
        # consume through to its sentinel.
        while dec.is_alive() or not decode_q.empty():
            try:
                if decode_q.get(timeout=0.1) is _SENTINEL:
                    break
            except queue.Empty:
                continue

    try:
        while True:
            with timer.stage("decode_wait"):
                chunk = decode_q.get()
            if chunk is _SENTINEL:
                break
            n_valid = chunk.shape[0]
            chunk = stab._pad(chunk)
            if halo is None:
                halo = stab._initial_halo(chunk[0])
                for i in range(depth):
                    if cuda:
                        staging.append(torch.empty(
                            chunk.shape, dtype=torch.uint8, pin_memory=True))
                        staged.append(None)
                    host.append(torch.empty(chunk.shape, dtype=torch.uint8,
                                            pin_memory=cuda))
                    free_q.put(i)
            with timer.stage("h2d"):
                dev_chunk = upload(chunk)
            with timer.stage("dispatch"):
                out_dev, halo, _ = stab._chunk(dev_chunk, halo)
                done = None
                if cuda:
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(dev))
            n_chunks += 1
            # Fetch the previous chunk only now: its step ran while this
            # chunk was decoded, staged and queued.
            if pending is not None:
                fetch(pending)
            pending = (out_dev, done, n_valid)
        if pending is not None:
            fetch(pending)
    except BaseException:
        # A failed step or fetch still retires both workers: a decode
        # thread parked on a full queue would leak, and the caller's
        # writer.close() must not race an in-flight write_batch.
        drain_decode()
        encode_q.put(_SENTINEL)
        enc.join()
        dec.join()
        raise
    encode_q.put(_SENTINEL)
    enc.join()
    dec.join()
    if errors:
        raise errors[0]
    return written
