"""Profiling: ``torch.profiler`` trace capture and per-op timings from the
trace, so ``stabilize --profile-dir`` reports kernel times, the device's
idle share and the program's spans straight from a profile rather than
from wall-clock guesses.

``trace`` writes a gzipped Chrome trace, ``<host>_<pid>_<ns>.pt.trace.
json.gz``, under the directory, with every thread's host ops and the span
``dvsg.profile`` around the block (its window, on the trace's clock). The
readers take the newest such file:

* ``summarize_trace`` aggregates the device lane of a trace taken on a card
  (kernels, memcpy and memset: the events Kineto's CUPTI tracing writes;
  not the copies of user annotations it puts beside them) and the
  ``cpu_op`` events of a CPU trace (there the fused warp shows as its
  registered op, ``dvsg_torch::warp_u8_offsets_rows``), spans left out;
* ``device_busy_stats`` is the union of the device-lane intervals over the
  window, NCCL's kernels kept apart (they wait for their peers); a CPU
  trace has no device lane (``None``);
* ``span_stats`` reads each ``dvsg.`` span (utils/metrics.py::span): its
  count, its host time and the device's idle time while it was open.

A trace taken on a card (Kineto records the card's ``deviceProperties``)
that holds no device event, as when CUPTI could not trace, makes the
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

from dvsg_tpu_torch.utils.metrics import SPAN_PREFIX, span

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = SPAN_PREFIX + "profile"


@contextlib.contextmanager
def trace(trace_dir: Optional[str], device) -> Iterator[None]:
    """A ``torch.profiler`` capture of the block into ``trace_dir``, with
    the CUDA activity when ``device`` is a card and the host ops of every
    thread; a no-op without a directory. The block, and on a card the
    wait for its device work, is the span ``dvsg.profile``."""
    if not trace_dir:
        yield
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(trace_dir, exist_ok=True)
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts, experimental_config=_ExperimentalConfig(
            profile_all_threads=True)) as prof:
        with span("profile"):                       # WINDOW
            yield
            if cuda:
                torch.cuda.synchronize(device)
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


def _complete(data: dict) -> list:
    return [ev for ev in data.get("traceEvents", []) if ev.get("ph") == "X"]


def _is_span(ev: dict) -> bool:
    return ev.get("cat") == "cpu_op" and str(ev.get("name", "")).startswith(
        SPAN_PREFIX)


def _lane(data: dict) -> tuple[list, bool]:
    """(the complete events of the trace's timing lane, whether it is the
    device lane). Raises on a card's trace without device events."""
    events = _complete(data)
    device = [ev for ev in events if ev.get("cat") in _DEVICE_CATS]
    if device:
        return device, True
    if data.get("deviceProperties"):
        raise RuntimeError(
            "the trace was taken on a card but holds no kernel, memcpy or "
            "memset event (CUPTI tracing unavailable?); refusing to "
            "summarize the host lane in its place")
    return [ev for ev in events if ev.get("cat") == "cpu_op"
            and not _is_span(ev)], False


def _interval(ev: dict) -> tuple[float, float]:
    return float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0))


def _union(intervals) -> list:
    """The sorted, disjoint union of (start, end) intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _length(union: list) -> float:
    return sum(e - s for s, e in union)


def _overlap(a: list, b: list) -> float:
    """Length of the intersection of two unions."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _window(data: dict) -> tuple[float, float]:
    for ev in _complete(data):
        if ev.get("cat") == "cpu_op" and ev.get("name") == WINDOW:
            return _interval(ev)
    raise RuntimeError(f"the trace has no {WINDOW} span: it was not "
                       "written by utils/profiling.py::trace")


def _busy(events: list, window: tuple[float, float]) -> tuple[list, list]:
    """(the union of the non-NCCL device events, that of NCCL's kernels),
    clipped to the window."""
    lo, hi = window
    work, nccl = [], []
    for ev in events:
        s, e = _interval(ev)
        s, e = max(s, lo), min(e, hi)
        if e > s:
            (nccl if "nccl" in str(ev.get("name", "")).lower()
             else work).append((s, e))
    return _union(work), _union(nccl)


def summarize_trace(trace_dir: str, min_us: float = 0.0) -> Dict[str, dict]:
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


def device_busy_stats(trace_dir: str) -> Optional[Dict[str, float]]:
    """Device busy-vs-idle split from the newest trace in trace_dir.

    Over the window that ``trace`` recorded: the union of the device-lane
    intervals (every stream's kernels, memcpys and memsets) but NCCL's
    kernels, and the union of NCCL's, each clipped to the window:
    {busy_ms, window_ms, idle_pct, nccl_ms, nccl_pct}. None when the trace
    has no device lane (a CPU trace, or no trace).
    """
    data = _newest_trace(trace_dir)
    if data is None:
        return None
    events, on_device = _lane(data)
    if not on_device:
        return None
    window = _window(data)
    span_us = window[1] - window[0]
    if span_us <= 0:
        return None
    work, nccl = _busy(events, window)
    busy, nccl_us = _length(work), _length(nccl)
    return {"busy_ms": busy / 1e3, "window_ms": span_us / 1e3,
            "idle_pct": 100.0 * (1.0 - busy / span_us),
            "nccl_ms": nccl_us / 1e3, "nccl_pct": 100.0 * nccl_us / span_us}


def span_stats(trace_dir: str) -> Dict[str, dict]:
    """Per ``dvsg.`` span name in the newest trace in trace_dir, but the
    window: {"count", "host_ms" (summed over its spans), "idle_ms" (while
    one of them was open, in the window, no device operation but NCCL's
    ran; None on a trace without a device lane)}, in order of first
    start."""
    data = _newest_trace(trace_dir)
    if data is None:
        return {}
    spans: Dict[str, list] = {}
    for ev in sorted(_complete(data), key=lambda ev: float(ev["ts"])):
        if _is_span(ev) and ev["name"] != WINDOW:
            spans.setdefault(ev["name"], []).append(_interval(ev))
    if not spans:
        return {}
    events, on_device = _lane(data)
    work = None
    if on_device:
        window = _window(data)
        work = _busy(events, window)[0]
    out = {}
    for name, ivs in spans.items():
        idle = None
        if work is not None:
            opened = _union((max(s, window[0]), min(e, window[1]))
                            for s, e in ivs if min(e, window[1])
                            > max(s, window[0]))
            idle = (_length(opened) - _overlap(opened, work)) / 1e3
        out[name] = {"count": len(ivs),
                     "host_ms": sum(e - s for s, e in ivs) / 1e3,
                     "idle_ms": idle}
    return out
