"""Profiling: ``torch.profiler`` trace capture and per-op timings from the
trace, so ``stabilize --profile-dir`` reports kernel times and the device's
idle share straight from a profile rather than from wall-clock guesses.

``trace`` writes a gzipped Chrome trace, ``<host>_<pid>_<ns>.pt.trace.
json.gz``, under the directory. The readers take the newest such file:

* ``summarize_trace`` aggregates the device lane of a trace taken on a card
  (kernels, memcpy and memset: the events Kineto's CUPTI tracing writes)
  and the ``cpu_op`` events of a CPU trace (there the fused warp shows as
  its registered op, ``dvsg_torch::warp_u8_offsets_rows``);
* ``device_busy_stats`` is the union of the device-lane intervals over
  their span; a CPU trace has no device lane (``None``).

A trace taken on a card (Kineto records the card's ``deviceProperties``)
that holds no device event, as when CUPTI could not trace, makes both
readers raise: they never quietly summarize the host instead.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import socket
import time
from typing import Dict, Iterator, Optional

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(trace_dir: Optional[str], device) -> Iterator[None]:
    """A ``torch.profiler`` capture of the block into ``trace_dir``, with
    the CUDA activity when ``device`` is a card; a no-op without a
    directory."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(trace_dir, exist_ok=True)
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield
    if cuda:
        torch.cuda.synchronize()
    name = f"{socket.gethostname()}_{os.getpid()}_{time.time_ns()}.pt"
    raw = os.path.join(trace_dir, name + ".trace.json")
    prof.export_chrome_trace(raw)
    with open(raw, "rb") as src, gzip.open(raw + ".gz", "wb") as dst:
        dst.write(src.read())
    os.remove(raw)


def _newest_trace(trace_dir: str) -> Optional[dict]:
    files = sorted(glob.glob(os.path.join(trace_dir, "**",
                                          "*.trace.json.gz"),
                             recursive=True), key=os.path.getmtime)
    if not files:
        return None
    with gzip.open(files[-1]) as fh:
        return json.load(fh)


def _lane(data: dict) -> tuple[list, bool]:
    """(the complete events of the trace's timing lane, whether it is the
    device lane). Raises on a card's trace without device events."""
    events = [ev for ev in data.get("traceEvents", [])
              if ev.get("ph") == "X"]
    device = [ev for ev in events if ev.get("cat") in _DEVICE_CATS]
    if device:
        return device, True
    if data.get("deviceProperties"):
        raise RuntimeError(
            "the trace was taken on a card but holds no kernel, memcpy or "
            "memset event (CUPTI tracing unavailable?); refusing to "
            "summarize the host lane in its place")
    return [ev for ev in events if ev.get("cat") == "cpu_op"], False


def summarize_trace(trace_dir: str, min_us: float = 50.0) -> Dict[str, dict]:
    """Aggregate op durations from the newest trace in trace_dir: the
    device lane of a card's trace, the ``cpu_op`` events of a CPU trace.

    Returns {op_name: {"mean_ms", "total_ms", "count"}} sorted by total,
    events shorter than ``min_us`` left out.
    """
    data = _newest_trace(trace_dir)
    if data is None:
        return {}
    buckets: Dict[str, list] = {}
    for ev in _lane(data)[0]:
        dur = float(ev.get("dur", 0))
        name = str(ev.get("name", ""))
        if dur < min_us or not name:
            continue
        buckets.setdefault(name, []).append(dur / 1e3)
    out = {name: {"mean_ms": sum(ds) / len(ds), "total_ms": sum(ds),
                  "count": len(ds)} for name, ds in buckets.items()}
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["total_ms"]))


def op_mean_ms(summary: Dict[str, dict], substring: str) -> Optional[float]:
    """Mean duration of the first op whose name contains substring."""
    for name, rec in summary.items():
        if substring in name:
            return rec["mean_ms"]
    return None


def device_busy_stats(trace_dir: str) -> Optional[Dict[str, float]]:
    """Device busy-vs-idle split from the newest trace in trace_dir.

    The union of the device-lane intervals (every stream's kernels,
    memcpys and memsets) against the span from the first device event's
    start to the last one's end: {busy_ms, span_ms, idle_pct}. None when
    the trace has no device lane (a CPU trace, or no trace).
    """
    data = _newest_trace(trace_dir)
    if data is None:
        return None
    events, on_device = _lane(data)
    if not on_device:
        return None
    intervals = sorted((float(ev["ts"]), float(ev["ts"]) + float(
        ev.get("dur", 0))) for ev in events)
    busy = 0.0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e for _, e in intervals) - intervals[0][0]
    if span <= 0:
        return None
    return {"busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "idle_pct": max(0.0, 100.0 * (1.0 - busy / span))}
