"""The benchmark cell ``stream-pwc-720p`` on the CPU at a small size: the
harness runs its driver (``portbench/drivers/stream_seeded.py``) traced
and reads the cell's metrics, ``correct`` holds, the parent's refusal of
the arch fails the run at once, and the sweep's control and faults read
above the program."""

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from dvsg_tpu_torch.models import motion_cnn  # noqa: E402
from portbench import harness  # noqa: E402

CELL = "stream-pwc-720p"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def spec():
    """The cell with a 64 x 64 model, window 3, and 48 x 64 chunks of 4
    frames: the published widths and radius, the traffic cut."""
    s = harness.load_spec(CELL)
    s.config = dict(s.config, model=dict(
        s.config["model"], model_size=[64, 64], grid_size=[4, 4], window=3))
    t = dict(s.traffic)
    t.update(height=48, width=64, chunk_frames=4, ring_chunks=3,
             octaves=[[4, 0.5], [16, 0.2]], edge_octave=4)
    s.traffic = t
    return s


def test_the_manifest_names_the_cell_and_its_metrics():
    s = harness.load_spec(CELL)
    assert s.traffic["kind"] == "stream_seeded"
    assert s.config["checkpoint"] is None and s.config["reduced"] == []
    assert {m["name"] for m in s.end_to_end} == {"frames_per_s", "setup_s"}
    names = {m["name"] for m in s.per_layer}
    assert {"mfu_pct.stream_pwc", "pwc_corr_roofline",
            "pwc_warp_roofline", "conv_ms_per_chunk"} <= names
    assert "mfu_pct.stream" not in names
    stream = harness.load_spec("stream-quality-720p").traffic
    assert {k: v for k, v in s.traffic.items()
            if k not in ("kind", "about")} == {
        k: v for k, v in stream.items() if k not in ("kind", "about")}


def test_a_traced_run_is_correct_and_reads_the_cells_metrics(spec):
    frames0, pairs0 = motion_cnn.PWC_FRAMES, motion_cnn.PWC_PAIRS
    res = harness.run_cell(spec, 2 ** 31 + 23, 0.5, True, "cpu",
                           time.monotonic())
    assert harness.correct(res, spec), res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert {"frames_per_s", "setup_s"} <= set(res["e2e"])
    assert res["layer"]["mfu_pct.stream_pwc"] > 0
    # no device kernels on the CPU: the rooflines read nothing
    assert "pwc_corr_roofline" not in res["layer"]
    # every chunk's pyramids and pairs, warm-up and checks' reruns aside
    chunks = res["attempted"]
    assert motion_cnn.PWC_FRAMES - frames0 >= chunks * (4 + 2)
    assert motion_cnn.PWC_PAIRS - pairs0 >= chunks * 4 * 2


def test_the_parent_port_fails_the_cell_at_once(spec, monkeypatch):
    """A port without the arch refuses it while the stream is built."""
    monkeypatch.setattr(motion_cnn, "_ARCHS", ("corr", "stacked"))
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="pwc"):
        harness.run_cell(spec, 7, 0.5, False, "cpu", t0)
    assert time.monotonic() - t0 < 30


def test_the_sweep_reads_the_control_and_every_fault(spec):
    rec, = harness.run_sweep(spec, [2 ** 31 + 5], "cpu")
    assert set(rec) >= {"program", "control", "halo_unchanged",
                        "answer_altered", "feature_warp_skipped",
                        "context_skipped", "saturated_share"}
    prog = rec["program"]["mismatch_share"]
    for fault in ("answer_altered", "feature_warp_skipped",
                  "context_skipped"):
        assert rec[fault]["mismatch_share"] > max(10 * prog, 1e-3), fault
    assert 0.0 <= rec["saturated_share"] < 0.5
