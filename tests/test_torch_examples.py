"""The port's examples (examples/torch/) stay runnable: each runs as a
subprocess the way its docstring tells a user to, on ``--device cpu``,
with the small arguments of tests/test_examples.py and its checks; the
serve round trip (not run by the reference's test) runs too, and without
a card the default device is an error, never a quiet CPU run."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# One intra-op thread a process: six test workers share the CPU.
ENV = dict(os.environ, OMP_NUM_THREADS="1")


def _run(script, *args, timeout=600):
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch", script),
         *args], capture_output=True, text=True, timeout=timeout, env=ENV)


@pytest.mark.parametrize("script,args,line", [
    pytest.param("01_library_quickstart.py", ("--frames", "12"), "gain +",
                 id="01"),
    pytest.param("02_streaming_online.py",
                 ("--frames", "9", "--chunk-frames", "4"),
                 "done: 9/9 stabilized frames", id="02"),
    pytest.param("03_serve_client.py", (), "stabilized ", id="03"),
    pytest.param("04_batch_data_parallel.py", (), "stabilized 8 clips",
                 id="04"),
    pytest.param("05_finetune_on_footage.py", ("--steps", "4"),
                 "on held-out footage:", id="05"),
    pytest.param("06_export_deploy.py", ("--frames", "8"),
                 "stabilized 8 frames from the artifact", id="06"),
    pytest.param("07_path_smoothing.py",
                 ("--frames", "32", "--horizon", "16"), "path_smooth=16",
                 id="07"),
])
def test_example_runs(script, args, line, tmp_path):
    if script in ("03_serve_client.py", "05_finetune_on_footage.py",
                  "07_path_smoothing.py"):
        pytest.importorskip("cv2")
    if script == "03_serve_client.py":
        args = ("--out", str(tmp_path / "stable.mp4"))
    r = _run(script, *args, "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    assert line in r.stdout, r.stdout


def test_no_card_is_an_error():
    r = _run("01_library_quickstart.py", "--frames", "4")
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
