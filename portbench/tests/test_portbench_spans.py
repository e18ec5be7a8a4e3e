"""The readers of the program's spans (``metrics/_spans.py`` and the
metrics that use it) on hand-made traces with known answers, and on a
trace without spans, as a program that opens none gives."""

import time

import pytest

from portbench import harness, tracing
# one_thread: the drivers' tests' autouse fixture, one torch thread a test
from test_portbench_drivers import _Ev, one_thread  # noqa: F401

SPAN_METRICS = ("draw_ms_per_step", "draw_idle_pct.train",
                "render_ms_per_step")


def _run(trace, steps=2, stages=None):
    return harness.Run(spec=None, rank=0, world=1, setup_s=0.0,
                       window_s=1e-3, work={"steps": steps}, stamps={},
                       stages=stages or {}, checks={}, attempted=steps,
                       failed=0, memory_peak_bytes=0, trace=trace)


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def _train_trace():
    """A 1 ms window (0 .. 1e6 ns) of two steps. Draw spans: one from
    before the window to 150 us, one 500-600 us, one from 950 us to past
    the window's end. A render span 200-400 us launches a 40 us kernel."""
    return tracing.Trace([
        _Ev("dvsg.draw", "cpu_op", -100_000, 250_000, cid=1),
        _Ev("aten::uniform_", "cpu_op", 10_000, 30_000, cid=2),
        _Ev("fill_kernel", "kernel", 0, 50_000, link=2),
        # NCCL waits inside a draw: no work, so idle for both readers.
        _Ev("ncclDevKernel_AllReduce", "kernel", 60_000, 60_000, link=0),
        _Ev("dvsg.render", "cpu_op", 200_000, 200_000, cid=3),
        _Ev("aten::grid_sampler_2d", "cpu_op", 210_000, 50_000, cid=4),
        _Ev("warp_kernel", "kernel", 300_000, 40_000, link=4),
        _Ev("dvsg.draw", "cpu_op", 500_000, 100_000, cid=5),
        _Ev("aten::copy_", "cpu_op", 540_000, 40_000, cid=6),
        _Ev("Memcpy HtoD", "gpu_memcpy", 550_000, 20_000, link=6),
        _Ev("aten::mm", "cpu_op", 610_000, 20_000, cid=7),
        _Ev("gemm_kernel", "kernel", 700_000, 100_000, link=7),
        _Ev("dvsg.draw", "cpu_op", 950_000, 150_000, cid=8),
    ], 0, 1_000_000)


def test_draw_time_is_clipped_to_the_window():
    # 150 + 100 + 50 us inside the window, over 2 steps
    assert _read("draw_ms_per_step", _run(_train_trace())) == \
        pytest.approx(0.15)


def test_draw_idle_share_leaves_nccl_out_and_stays_under_the_idle_share():
    run = _run(_train_trace())
    # 300 us of draws, 50 us (fill) + 20 us (copy) of them busy
    got = _read("draw_idle_pct.train", run)
    assert got == pytest.approx(23.0)
    # busy 50 + 40 + 20 + 100 us of the 1 ms window
    idle = _read("device_idle_pct.train", run)
    assert idle == pytest.approx(79.0) and got <= idle


def test_render_reads_the_kernels_launched_inside_it():
    assert _read("render_ms_per_step", _run(_train_trace())) == \
        pytest.approx(0.02)                      # 40 us over 2 steps


def test_spans_on_two_threads_are_one_union():
    evs = [_Ev("dvsg.draw", "cpu_op", 0, 400_000, cid=1, tid=1),
           _Ev("dvsg.draw", "cpu_op", 200_000, 400_000, cid=2, tid=2)]
    run = _run(tracing.Trace(evs, 0, 1_000_000), steps=3)
    assert _read("draw_ms_per_step", run) == pytest.approx(0.2)
    assert _read("draw_idle_pct.train", run) == pytest.approx(60.0)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_trace_without_spans_reads_nothing(name):
    no_spans = tracing.Trace([
        _Ev("aten::mm", "cpu_op", 0, 20_000, cid=1),
        _Ev("gemm_kernel", "kernel", 10_000, 100_000, link=1),
    ], 0, 1_000_000)
    assert _read(name, _run(no_spans)) is None
    assert _read(name, _run(None)) is None
    # a span wholly outside the window is not in it
    outside = tracing.Trace([_Ev("dvsg.draw", "cpu_op", -50, 40, cid=1),
                             _Ev("dvsg.render", "cpu_op", -50, 40, cid=2)],
                            0, 1_000_000)
    assert _read(name, _run(outside)) is None


def test_dispatch_reads_its_stage():
    stages = {"h2d": {"total_s": 1.0, "count": 4, "mean_ms": 250.0},
              "dispatch": {"total_s": 0.005, "count": 4, "mean_ms": 1.25}}
    assert _read("dispatch_ms_per_chunk", _run(None, stages=stages)) == 1.25
    assert _read("dispatch_ms_per_chunk", _run(None)) is None


@pytest.mark.parametrize("cell,names", [
    ("train-fast-b32", SPAN_METRICS),
    ("stream-quality-720p", ("dispatch_ms_per_chunk",))])
def test_tiny_traced_runs_report_the_new_metrics(tiny, cell, names):
    """The program opens its spans under the harness's profiler, so a
    traced run of each cell reads every new metric of the cell."""
    res = harness.run_cell(tiny(cell), 2 ** 31 + 17, 0.5, True, "cpu",
                           time.monotonic())
    layer = res["layer"]
    assert set(names) <= set(layer), layer
    if "draw_idle_pct.train" in names:
        assert layer["draw_ms_per_step"] > 0
        assert layer["draw_idle_pct.train"] <= layer["device_idle_pct.train"]
