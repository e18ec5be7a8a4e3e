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


def _cpu_op(name, ts, dur):
    return {"ph": "X", "cat": "cpu_op", "name": name, "pid": 1, "tid": 1,
            "ts": ts, "dur": dur}


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


def test_op_mean_ms():
    s = {"fusion.1": {"mean_ms": 2.0, "total_ms": 4.0, "count": 2}}
    assert profiling.op_mean_ms(s, "fusion") == 2.0
    assert profiling.op_mean_ms(s, "nope") is None


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
    assert profiling.device_busy_stats(prof) is None
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "[profile]" in ln]
    assert 1 <= len(lines) <= 9 and any(op in ln for ln in lines)
    assert not any("device busy" in ln for ln in lines)


def test_device_busy_stats_is_the_union_of_kernels(tmp_path):
    """Kernels on two streams overlap; busy time is their union over the
    span of the device lane, and the CPU lane is left out of both
    readers."""
    d = _write_trace(tmp_path, [
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
    assert busy["span_ms"] == pytest.approx(0.32)       # 100 .. 420 us
    assert busy["idle_pct"] == pytest.approx(37.5)
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
