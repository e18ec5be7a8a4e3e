"""Every traffic mix's control flow in a tiny run on the CPU, through the
same harness, drivers, readers and comparison as on the card (the
harness's look for a card skipped): sound runs come out correct, and a
run with its timed path broken underneath comes out not correct."""

import time

import pytest
import torch

from portbench import harness, tracing

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(spec, fault=None, trace=False):
    res = harness.run_cell(spec, 2 ** 31 + 17, 0.5, trace, "cpu",
                           time.monotonic(), fault=fault)
    return res, harness.correct(res, spec)


def test_stream(tiny):
    spec = tiny("stream-quality-720p")
    res, ok = run(spec, trace=True)
    assert ok, res["checks"]
    e2e = res["e2e"]
    assert set(e2e) == {"frames_per_s", "setup_s"}
    assert e2e["frames_per_s"] > 0 and res["failed"] == 0
    assert {"chunk_latency_p95_ms", "h2d_ms_per_chunk",
            "mfu_pct.stream"} <= set(res["layer"])
    assert res["layer"]["chunk_latency_p95_ms"] > 0
    line = harness.result_line(res, spec, {"platform": "cpu"})
    assert list(line)[-1] == "checks" and line["correct"]


@pytest.mark.parametrize("fault", ["halo_unchanged", "answer_altered"])
def test_stream_faults_are_caught(tiny, fault):
    res, ok = run(tiny("stream-quality-720p"), fault)
    assert not ok, res["checks"]


def test_train(tiny):
    spec = tiny("train-fast-b32")
    res, ok = run(spec, trace=True)
    assert ok, res["checks"]
    assert set(res["e2e"]) == {"train_samples_per_s", "setup_s"}
    assert "mfu_pct.train" in res["layer"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_train_faults_are_caught(tiny, fault):
    res, ok = run(tiny("train-fast-b32"), fault)
    assert not ok, res["checks"]


@pytest.mark.parametrize("fault", [None, "no_exchange", "half_batch"])
def test_dp_train_over_gloo_ranks(tiny, fault):
    spec = tiny("dptrain-quality-b32-4card")
    spec.traffic.update(ranks=2, batch_size=4)
    res, ok = run(spec, fault)
    assert ok == (fault is None), res["checks"]


class _Ev:
    def __init__(self, name, kind, start, dur, cid=0, link=0, tid=1):
        self._v = (name, kind, start, dur, cid, link, tid)

    def name(self):
        return self._v[0]

    def device_type(self):
        return (torch.autograd.DeviceType.CPU if self._v[1] == "cpu_op"
                else torch.autograd.DeviceType.CUDA)

    def is_user_annotation(self):
        return False

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


def test_trace_reduction():
    evs = [
        _Ev("aten::conv2d", "cpu_op", 0, 500_000, cid=1),
        _Ev("aten::cudnn_convolution", "cpu_op", 10_000, 400_000, cid=2),
        _Ev("aten::add", "cpu_op", 600_000, 300_000, cid=3),
        _Ev("conv_kernel", "kernel", 100_000, 200_000, link=2),
        _Ev("ncclAllReduce", "kernel", 300_000, 100_000, link=0),
        _Ev("add_kernel", "kernel", 850_000, 50_000, link=3),
        _Ev("Memcpy HtoD", "gpu_memcpy", 950_000, 10_000),
    ]
    t = tracing.Trace(evs, 0, 1_000_000)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s() == pytest.approx(360e-6)
    assert t.compute_busy_s() == pytest.approx(260e-6)
    conv = t.under("convolution")
    assert t.sum_s(conv) == pytest.approx(200e-6)
    assert t.count(conv) == 1
    gaps = dict(t.idle_gaps())
    # 0-100 us: before the conv kernel, inside cudnn_convolution
    assert gaps["aten::cudnn_convolution"] == pytest.approx(100e-6)
    # 400-850 us: before add_kernel: add runs from 600 us
    assert gaps["aten::add"] == pytest.approx(250e-6)
    assert sum(gaps.values()) == pytest.approx(1e-3 - 360e-6)
