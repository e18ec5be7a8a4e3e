"""The port's profiler (utils/profiling.py): the counterparts of
tests/test_profiling.py, ``stabilize --profile-dir`` on the CPU, and the
device-lane readers on hand-written traces of a card."""

import gzip
import json
import os

import cv2
import numpy as np
import pytest
import torch

from dvsg_tpu_torch import cli
from dvsg_tpu_torch.utils import profiling


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_trace(path, events, card: bool):
    """A Kineto-shaped Chrome trace: a card's carries its
    ``deviceProperties``."""
    data = {"traceEvents": events}
    if card:
        data["deviceProperties"] = [{"id": 0, "name": "NVIDIA H100"}]
    os.makedirs(path, exist_ok=True)
    with gzip.open(os.path.join(path, "h_1_1.pt.trace.json.gz"), "wt") as f:
        json.dump(data, f)
    return str(path)


def _kernel(name, ts, dur, stream=7):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0,
            "tid": stream, "ts": ts, "dur": dur}


def _cpu_op(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "cpu_op", "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur}


def _window(ts, dur):
    """The span ``trace`` opens around the profiled block."""
    return _cpu_op(profiling.WINDOW, ts, dur)


def test_trace_noop_without_dir(tmp_path):
    with profiling.trace(None, "cpu"):
        pass
    with profiling.trace("", "cpu"):
        pass
    assert os.listdir(tmp_path) == []


def test_trace_capture_and_summarize(tmp_path):
    d = str(tmp_path / "trace")
    x = torch.from_numpy(np.random.default_rng(0).random((256, 256),
                                                         np.float32))
    with profiling.trace(d, "cpu"):
        for _ in range(3):
            torch.tanh(x @ x.T).sum()
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json.gz")
    summary = profiling.summarize_trace(d, min_us=1.0)
    assert summary and "aten::mm" in summary
    assert summary["aten::mm"]["count"] == 3
    totals = [rec["total_ms"] for rec in summary.values()]
    assert totals == sorted(totals, reverse=True)
    for rec in summary.values():
        assert rec["count"] >= 1 and rec["mean_ms"] >= 0
        assert rec["total_ms"] == pytest.approx(rec["mean_ms"]
                                                * rec["count"])
    assert profiling.device_busy_stats(d) is None    # no device lane


def test_summarize_empty_dir(tmp_path):
    assert profiling.summarize_trace(str(tmp_path)) == {}
    assert profiling.device_busy_stats(str(tmp_path)) is None


def test_stabilize_profile_dir_on_the_cpu(tmp_path, capsys):
    """``stabilize --profile-dir`` on the CPU: the trace's cpu_op summary
    names the fused warp's registered op, one call a chunk, and the
    printed [profile] lines do too; a CPU trace has no device lane."""
    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.default_rng(0)
    for i in range(10):
        cv2.imwrite(str(src / f"{i:05d}.png"),
                    rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    prof = str(tmp_path / "prof")
    assert cli.main(["stabilize", "--input", str(src), "--output",
                     str(tmp_path / "out"), "--platform", "cpu",
                     "--chunk-frames", "4", "--profile-dir", prof]) == 0
    summary = profiling.summarize_trace(prof, min_us=0.0)
    op = "dvsg_torch::warp_u8_offsets_rows"
    assert summary[op]["count"] == 3
    assert not any(name.startswith("dvsg.") for name in summary)
    assert profiling.device_busy_stats(prof) is None
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "[profile]" in ln]
    ops = [ln for ln in lines if "[profile] span " not in ln]
    assert 1 <= len(ops) <= 9 and any(op in ln for ln in ops)
    # one line per stage of the sync stream, without a device's idle time
    spans = [ln.split()[2] for ln in lines if "[profile] span " in ln]
    assert sorted(spans) == ["dvsg.compute", "dvsg.d2h", "dvsg.decode",
                             "dvsg.encode", "dvsg.h2d"]
    assert not any("device" in ln for ln in lines)


def test_device_busy_stats_is_the_union_of_kernels(tmp_path):
    """Kernels on two streams overlap; busy time is their union over the
    profiled window, and the CPU lane is left out of both readers."""
    d = _write_trace(tmp_path, [
        _window(0, 500),
        _kernel("a", 100, 50), _kernel("b", 120, 60, stream=8),  # 100-180
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "pid": 0,
         "tid": 9, "ts": 300, "dur": 100},                       # 300-400
        _kernel("a", 390, 30),                                   # to 420
        _cpu_op("aten::conv2d", 0, 1000),
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
    ], card=True)
    busy = profiling.device_busy_stats(d)
    assert busy["busy_ms"] == pytest.approx(0.2)        # 80 + 120 us
    assert busy["window_ms"] == pytest.approx(0.5)      # 0 .. 500 us
    assert busy["idle_pct"] == pytest.approx(60.0)
    assert busy["nccl_ms"] == 0.0
    summary = profiling.summarize_trace(d, min_us=0.0)
    assert list(summary) == ["Memcpy DtoH", "a", "b"]
    assert summary["a"] == {"mean_ms": pytest.approx(0.04),
                            "total_ms": pytest.approx(0.08), "count": 2}
    assert "aten::conv2d" not in summary


def test_card_trace_without_a_device_lane_raises(tmp_path):
    """A trace taken on a card with no kernel event (CUPTI tracing
    missing) is refused, never summarized from the host lane."""
    d = _write_trace(tmp_path, [_cpu_op("aten::conv2d", 0, 1000),
                                _cpu_op("aten::mm", 10, 200)], card=True)
    with pytest.raises(RuntimeError, match="no kernel"):
        profiling.summarize_trace(d)
    with pytest.raises(RuntimeError, match="no kernel"):
        profiling.device_busy_stats(d)
    # The same events from a CPU run: the host lane, no device lane.
    cpu = _write_trace(tmp_path / "cpu", [_cpu_op("aten::conv2d", 0, 1000)],
                       card=False)
    assert list(profiling.summarize_trace(cpu)) == ["aten::conv2d"]
    assert profiling.device_busy_stats(cpu) is None


def _annotation(name, ts, dur):
    """Kineto's copy of a user annotation (``record_function``, the
    optimizer's step) on the device lane."""
    return {"ph": "X", "cat": "gpu_user_annotation", "name": name, "pid": 0,
            "tid": 7, "ts": ts, "dur": dur}


def test_device_busy_stats_clips_to_the_window_and_keeps_nccl_apart(
        tmp_path):
    """The window bounds the busy time; NCCL's kernels are their own
    share, not work; annotations copied onto the device lane are neither
    counted nor summarized."""
    d = _write_trace(tmp_path, [
        _window(100, 1000),                                  # 100 .. 1100
        _kernel("early", 50, 100),                           # 50 us inside
        _kernel("ncclDevKernel_AllReduce_Sum_f32", 200, 200),
        _kernel("gemm", 300, 50),                            # under NCCL
        _annotation("Optimizer.step#AdamW.step", 500, 400),
        _kernel("late", 1050, 150),                          # 50 us inside
    ], card=True)
    busy = profiling.device_busy_stats(d)
    assert busy["window_ms"] == pytest.approx(1.0)
    assert busy["busy_ms"] == pytest.approx(0.15)
    assert busy["idle_pct"] == pytest.approx(85.0)
    assert busy["nccl_ms"] == pytest.approx(0.2)
    assert busy["nccl_pct"] == pytest.approx(20.0)
    summary = profiling.summarize_trace(d)
    assert "Optimizer.step#AdamW.step" not in summary
    assert summary["gemm"]["count"] == 1            # no 50 us floor


def test_card_trace_without_its_window_raises(tmp_path):
    d = _write_trace(tmp_path, [_kernel("a", 100, 50)], card=True)
    with pytest.raises(RuntimeError, match="dvsg.profile"):
        profiling.device_busy_stats(d)


def test_span_stats_reads_count_host_time_and_device_idle(tmp_path):
    """Per span name: its count, its host time, and the device's idle
    time (NCCL's kernels are no work) while one was open in the window."""
    d = _write_trace(tmp_path, [
        _window(0, 1100),
        _cpu_op("dvsg.h2d", 100, 200),          # busy 100 .. 150
        _cpu_op("dvsg.h2d", 600, 100),          # NCCL only: idle
        _cpu_op("dvsg.decode", 1000, 300, tid=2),   # past the window's end
        _kernel("a", 100, 50),
        _kernel("ncclDevKernel_Broadcast", 600, 100),
        _kernel("b", 1050, 200),
    ], card=True)
    stats = profiling.span_stats(d)
    assert list(stats) == ["dvsg.h2d", "dvsg.decode"]
    assert stats["dvsg.h2d"] == {"count": 2, "host_ms": pytest.approx(0.3),
                                 "idle_ms": pytest.approx(0.25)}
    assert stats["dvsg.decode"] == {"count": 1,
                                    "host_ms": pytest.approx(0.3),
                                    "idle_ms": pytest.approx(0.05)}
    cpu = _write_trace(tmp_path / "cpu", [_window(0, 500),
                                          _cpu_op("dvsg.h2d", 10, 20)],
                       card=False)
    assert profiling.span_stats(cpu) == {
        "dvsg.h2d": {"count": 1, "host_ms": pytest.approx(0.02),
                     "idle_ms": None}}


def test_profile_dir_of_the_overlapped_stream_reads_its_workers(tmp_path,
                                                                capsys):
    """``stabilize --overlap --profile-dir``: the trace holds every
    thread's spans, the decode and encode workers' among them, one a
    chunk."""
    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.default_rng(1)
    for i in range(10):
        cv2.imwrite(str(src / f"{i:05d}.png"),
                    rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    prof = str(tmp_path / "prof")
    assert cli.main(["stabilize", "--input", str(src), "--output",
                     str(tmp_path / "out"), "--platform", "cpu",
                     "--chunk-frames", "4", "--overlap", "--profile-dir",
                     prof]) == 0
    stats = profiling.span_stats(prof)
    assert stats["dvsg.decode"]["count"] == 3       # 4 + 4 + 2 frames
    assert stats["dvsg.encode"]["count"] == 3
    assert stats["dvsg.dispatch"]["count"] == 3
    out = capsys.readouterr().out
    assert "[profile] span dvsg.decode x3: host" in out
