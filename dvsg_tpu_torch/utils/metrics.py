"""Quality and throughput metrics: PSNR, per-stage wall-clock timing and
the spans that put the stages into a ``torch.profiler`` trace."""

from __future__ import annotations

import contextlib
import json
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_PREFIX = "dvsg."
_NO_SPAN = contextlib.nullcontext()


def psnr(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB between two arrays in [0, max_val].

    uint8 inputs are normalized to [0, 1] automatically.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    if a.dtype == np.uint8:
        a = a.astype(np.float64) / 255.0
    if b.dtype == np.uint8:
        b = b.astype(np.float64) / 255.0
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0.0:
        return float("inf")
    return 10.0 * np.log10((max_val ** 2) / mse)


def span(name: str):
    """A host range named ``dvsg.<name>`` around a ``with`` block, while a
    ``torch.profiler`` is running; otherwise a no-op that costs one flag
    check.

    The range is a plain host op (``cpu_op``) on the trace's clock, with
    its thread, start and end; spans of one thread nest. It is not a user
    annotation (``record_function``), which Kineto would copy onto the
    device lane. Spans stay in the profiler's memory with its other
    events."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + name)


class StageTimer:
    """Wall-clock accounting per pipeline stage (decode/h2d/compute/d2h/
    encode). A stage that ends in a device synchronize measures the
    device's work; one that does not measures only the enqueue. Each
    stage is also a ``span`` of its name.

    Stages may be timed on several threads, but each stage name on one
    thread only, so the totals need no lock; read ``summary`` once those
    threads are done."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    class _Ctx:
        def __init__(self, timer: "StageTimer", name: str):
            self.timer, self.name = timer, name

        def __enter__(self):
            self.span = span(self.name)
            self.span.__enter__()
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dt = time.perf_counter() - self.t0
            self.span.__exit__(*exc)
            self.timer.totals[self.name] = (
                self.timer.totals.get(self.name, 0.0) + dt)
            self.timer.counts[self.name] = (
                self.timer.counts.get(self.name, 0) + 1)

    def stage(self, name: str) -> "StageTimer._Ctx":
        return StageTimer._Ctx(self, name)

    def summary(self) -> dict:
        return {
            name: {"total_s": self.totals[name],
                   "count": self.counts[name],
                   "mean_ms": 1e3 * self.totals[name] / self.counts[name]}
            for name in self.totals
        }


def write_metrics_jsonl(path: str, record: dict) -> None:
    """Append one JSON line (with a ``ts`` timestamp) to ``path``."""
    record = dict(record)
    record.setdefault("ts", time.time())
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
