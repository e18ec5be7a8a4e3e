"""The program's spans (utils/metrics.py::span) on the CPU: host ops named
``dvsg.<name>`` on the profiler's clock while a profiler runs, nothing
without one; ``StageTimer``'s stages as spans; one ``draw`` and one
``render`` span per training step."""

import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dvsg_tpu_torch.config import TrainConfig
from dvsg_tpu_torch.parallel import dryrun
from dvsg_tpu_torch.train import loop
from dvsg_tpu_torch.utils import metrics
from dvsg_tpu_torch.utils.metrics import StageTimer, span


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(fn, all_threads=False):
    kw = {}
    if all_threads:
        from torch._C._profiler import _ExperimentalConfig
        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
        fn()
    return list(prof.profiler.kineto_results.events())


def _named(events, name):
    return [e for e in events if e.name() == name]


def test_a_span_is_a_host_op_around_its_work():
    x = torch.ones(64, 64)
    stamps = {}

    def work():
        stamps["before"] = time.time_ns()
        with span("x"):
            with span("inner"):
                torch.mm(x, x)
        stamps["after"] = time.time_ns()

    events = _events(work)
    (sp,), (inner,), (mm,) = (_named(events, n)
                              for n in ("dvsg.x", "dvsg.inner", "aten::mm"))
    assert sp.device_type() == torch.autograd.DeviceType.CPU
    assert not sp.is_user_annotation()
    end = lambda e: e.start_ns() + e.duration_ns()  # noqa: E731
    assert stamps["before"] <= sp.start_ns() <= end(sp) <= stamps["after"]
    # spans nest, and enclose the ops run inside them on their thread
    for outer, e in ((sp, inner), (inner, mm)):
        assert e.start_thread_id() == outer.start_thread_id()
        assert outer.start_ns() <= e.start_ns() <= end(e) <= end(outer)


def test_a_span_on_another_thread_keeps_its_thread():
    def worker():
        with span("worker"):
            torch.ones(8).sum()

    def work():
        with span("main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()

    events = _events(work, all_threads=True)
    (main,), (other,) = (_named(events, n)
                         for n in ("dvsg.main", "dvsg.worker"))
    assert main.start_thread_id() != other.start_thread_id()


def test_without_a_profiler_a_span_is_the_shared_noop():
    assert span("x") is span("y") is metrics._NO_SPAN
    with span("x") as got:
        assert got is None


def test_a_stage_totals_counts_and_is_a_span():
    timer = StageTimer()

    def work():
        for _ in range(3):
            with timer.stage("h2d"):
                time.sleep(0.001)

    with timer.stage("h2d"):                # no profiler: timed all the same
        time.sleep(0.001)
    events = _events(work)
    got = timer.summary()["h2d"]
    assert got["count"] == 4 and got["total_s"] >= 0.004
    assert got["mean_ms"] == pytest.approx(1e3 * got["total_s"] / 4)
    spans = _named(events, "dvsg.h2d")
    assert len(spans) == 3
    assert all(e.duration_ns() >= 1_000_000 for e in spans)


def test_one_timer_on_many_threads_loses_no_count():
    """Threads share a timer, each stage name on one thread (as the
    overlapped stream's workers do): with switches forced every
    microsecond, no count or total is lost."""
    timer, n, per = StageTimer(), 16, 2000

    def work(i):
        for _ in range(per):
            with timer.stage(f"s{i}"):
                pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    got = timer.summary()
    assert sorted(got) == sorted(f"s{i}" for i in range(n))
    assert all(rec["count"] == per and rec["total_s"] > 0
               for rec in got.values())


def test_a_train_step_draws_and_renders_once():
    mcfg, params = dryrun.tiny_setup()
    cfg = TrainConfig(model=mcfg, batch_size=2, steps=4, warmup_steps=1,
                      checkpoint_every=0)
    state = loop.build_state(cfg, params, "cpu")
    events = _events(lambda: loop.train_step(
        state, loop.step_generator(0, 0), cfg))
    (draw,), (render,) = (_named(events, n)
                          for n in ("dvsg.draw", "dvsg.render"))
    assert draw.start_ns() + draw.duration_ns() <= render.start_ns()
    inside = lambda e, sp: (sp.start_ns() <= e.start_ns()  # noqa: E731
                            <= sp.start_ns() + sp.duration_ns())
    # the frames are repeated for the render warp inside the render span;
    # the model's convolutions run after both
    assert any(inside(e, render) for e in
               _named(events, "aten::repeat_interleave"))
    convs = _named(events, "aten::convolution")
    assert convs and not any(inside(e, sp) for e in convs
                             for sp in (draw, render))
