"""Quality and throughput metrics: PSNR and per-stage wall-clock timing."""

from __future__ import annotations

import json
import time

import numpy as np


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


class StageTimer:
    """Wall-clock accounting per pipeline stage (decode/h2d/compute/d2h/
    encode). A stage that ends in a device synchronize measures the
    device's work; one that does not measures only the enqueue."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    class _Ctx:
        def __init__(self, timer: "StageTimer", name: str):
            self.timer, self.name = timer, name

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dt = time.perf_counter() - self.t0
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
