"""The device trace of a measured window, reduced in memory.

``capture`` wraps the window in ``torch.profiler`` (host ops and, on a
card, CUPTI's device activity) and returns a ``Trace`` of the raw events
that fall inside the window, on the host's clock (ns since the epoch, as
``time.time_ns``). Nothing is written to disk.

A ``Trace`` answers what the per-layer metrics ask:

* ``union_s(pred)``: seconds in which some device operation that ``pred``
  accepts was running, on any stream; ``busy_s`` is that for every device
  operation, ``compute_busy_s`` for every one but NCCL's kernels, which
  wait for their peers and so are kept apart;
* ``sum_s(pred)``: the summed durations of the device operations that
  ``pred`` accepts (a kernel's own time);
* ``under(substring)``: a predicate for kernels launched inside a host op
  whose name holds ``substring`` (by the launch's linked op and the ops
  enclosing it on the launching thread);
* ``idle_gaps()``: the stretches with no device operation, each second of
  them named by the innermost host op that was running on the thread that
  launched the operation ending the gap ("no_host_op" where none was).
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Callable, Iterator, Optional

import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation")
# Gaps shorter than this are launch gaps: no host op explains them.
SHORT_GAP_NS = 20_000
NAME_CHARS = 96


def is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


def short_name(name: str) -> str:
    """A kernel's name without its argument list, at most ``NAME_CHARS``
    characters."""
    return name.split("(")[0][:NAME_CHARS]


def _kind(ev) -> str:
    """The activity of a raw profiler event, told by its device and name:
    one of ``DEVICE_KINDS``, ``HOST_KINDS`` or "other"."""
    if ev.device_type() == torch.autograd.DeviceType.CUDA:
        name = ev.name()
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if ev.device_type() == torch.autograd.DeviceType.CPU:
        if ev.is_user_annotation():
            return "user_annotation"
        # CUDA runtime and driver calls (cudaLaunchKernel, cuLaunchKernel)
        return "cuda_runtime" if ev.name().startswith("cu") else "cpu_op"
    return "other"


class Trace:
    def __init__(self, events, t0_ns: int, t1_ns: int):
        self.t0_ns, self.t1_ns = t0_ns, t1_ns
        # (start, end, name, kind, linked op id), clipped to the window
        self.device = []
        self.ops = {}                       # id -> (name, start, end, tid)
        by_thread = defaultdict(list)       # tid -> [(start, end, name)]
        for ev in events:
            kind = _kind(ev)
            start = ev.start_ns()
            end = start + ev.duration_ns()
            if kind in DEVICE_KINDS:
                s, e = max(start, t0_ns), min(end, t1_ns)
                if e > s:
                    self.device.append((s, e, ev.name(), kind,
                                        ev.linked_correlation_id()))
            elif kind in HOST_KINDS:
                self.ops[ev.correlation_id()] = (ev.name(), start, end,
                                                 ev.start_thread_id())
                by_thread[ev.start_thread_id()].append((start, end, ev.name()))
        self.device.sort()
        # Per thread, ops in start order with their parents (host ops of
        # one thread nest), so the innermost op running at a time is found
        # by walking up from the last op started before it.
        self.threads = {}
        for tid, ops in by_thread.items():
            ops.sort(key=lambda o: (o[0], -o[1]))
            parent, stack = [], []
            for i, (s, e, _) in enumerate(ops):
                while stack and ops[stack[-1]][1] <= s:
                    stack.pop()
                parent.append(stack[-1] if stack else -1)
                stack.append(i)
            self.threads[tid] = ([o[0] for o in ops], ops, parent)
        self._op_index = {}
        for cid, (name, s, e, tid) in self.ops.items():
            starts, ops, _ = self.threads[tid]
            i = bisect.bisect_left(starts, s)
            while i < len(ops) and ops[i][0] == s and ops[i][2] != name:
                i += 1
            self._op_index[cid] = (tid, i)

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def union_s(self, pred: Optional[Callable] = None) -> float:
        total, cur_s, cur_e = 0, None, None
        for s, e, name, kind, link in self.device:
            if pred is not None and not pred(name, kind, link):
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total / 1e9

    def busy_s(self) -> float:
        return self.union_s()

    def compute_busy_s(self) -> float:
        return self.union_s(lambda name, kind, link: not is_nccl(name))

    def sum_s(self, pred: Callable) -> float:
        return sum(e - s for s, e, name, kind, link in self.device
                   if pred(name, kind, link)) / 1e9

    def count(self, pred: Callable) -> int:
        return sum(1 for s, e, name, kind, link in self.device
                   if pred(name, kind, link))

    def innermost(self, tid, t_ns: int) -> int:
        """Index of the innermost op of thread ``tid`` running at ``t_ns``
        (-1 for none)."""
        starts, ops, parent = self.threads[tid]
        i = bisect.bisect_right(starts, t_ns) - 1
        while i >= 0 and ops[i][1] <= t_ns:
            i = parent[i]
        return i

    def under(self, substring: str) -> Callable:
        """Predicate: a kernel launched inside a host op named with
        ``substring``."""
        memo: dict = {}

        def pred(name, kind, link):
            if kind != "kernel":
                return False
            if link not in memo:
                hit = False
                if link in self._op_index:
                    tid, i = self._op_index[link]
                    _, ops, parent = self.threads[tid]
                    while i >= 0 and not hit:
                        hit = substring in ops[i][2]
                        i = parent[i]
                memo[link] = hit
            return memo[link]
        return pred

    def top_ops(self, k: int = 10) -> list:
        """The k device operations that took most time: [[name, s], ...],
        a kernel named without its argument list, cut to ``NAME_CHARS``."""
        tot: dict = defaultdict(int)
        for s, e, name, kind, link in self.device:
            tot[short_name(name)] += e - s
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[name, ns / 1e9] for name, ns in best]

    def idle_gaps(self, k: int = 10) -> list:
        """The k host labels under which the device idled longest:
        [[label, s], ...]."""
        tot: dict = defaultdict(int)
        prev_end = self.t0_ns
        for s, e, name, kind, link in self.device + [
                (self.t1_ns, self.t1_ns, "", "", None)]:
            if s > prev_end:
                self._attribute(prev_end, s, link, tot)
            prev_end = max(prev_end, e)
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[label, ns / 1e9] for label, ns in best]

    def _attribute(self, gs: int, ge: int, link, tot: dict) -> None:
        if ge - gs < SHORT_GAP_NS:
            tot["launch_gap_under_20us"] += ge - gs
            return
        op = self.ops.get(link)
        if op is None:
            tot["no_host_op"] += ge - gs
            return
        tid = op[3]
        starts, ops, parent = self.threads[tid]
        lo = bisect.bisect_right(starts, gs)
        hi = bisect.bisect_left(starts, ge)
        # Cut the gap at every op boundary inside it and give each piece
        # to the innermost op running there.
        cuts = {gs, ge}
        i = self.innermost(tid, gs)
        while i >= 0:
            if ops[i][1] < ge:
                cuts.add(ops[i][1])
            i = parent[i]
        for s, e, _ in ops[lo:hi]:
            cuts.add(s)
            if e < ge:
                cuts.add(e)
        cuts = sorted(cuts)
        for a, b in zip(cuts, cuts[1:]):
            i = self.innermost(tid, (a + b) // 2)
            tot[ops[i][2] if i >= 0 else "no_host_op"] += b - a


@contextlib.contextmanager
def capture(device: torch.device, out: list) -> Iterator[None]:
    """Profile the block; append its ``Trace`` to ``out``. The block's
    start and end on the host clock bound the trace: the window is the
    block itself, after the profiler has started."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    t0 = time.time_ns()
    try:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.time_ns()
    finally:
        prof.__exit__(None, None, None)
    events = prof.profiler.kineto_results.events()
    trace = Trace(events, t0, t1)
    if device.type == "cuda" and not trace.device:
        raise RuntimeError("the trace of a card holds no device operation "
                           "(CUPTI could not trace?)")
    out.append(trace)
