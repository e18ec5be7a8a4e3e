"""No module of the benchmark imports JAX or the JAX package; the plain
reference imports nothing of the port; nothing reads the TPU bench."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench import harness

SOURCES = sorted(glob.glob(os.path.join(ROOT, "portbench", "**", "*.py"),
                           recursive=True))


def imported(path: str) -> set:
    """Top-level names of every module ``path`` imports, as whole names."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    assert not imported(path) & set(harness.FORBIDDEN)


def test_whole_names_are_compared():
    # dvsg_tpu_torch begins with dvsg_tpu but is not it
    assert "dvsg_tpu_torch".split(".")[0] not in harness.FORBIDDEN


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    ROOT, "portbench", "reference", "*.py"))),
    ids=lambda p: os.path.basename(p))
def test_reference_is_plain(path):
    assert not imported(path) & {"dvsg_tpu_torch", "dvsg_tpu", "jax"}


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_tpu_bench_not_read(path):
    if path == os.path.abspath(__file__):
        return
    with open(path) as f:
        text = f.read()
    for name in ("bench.py", "BENCH_r", "MULTICHIP_r", "bench_detail"):
        assert name not in text, name


def test_runs_load_no_jax(tmp_path):
    """A tiny run of every traffic kind in a fresh process leaves no
    forbidden module in ``sys.modules``."""
    tests = os.path.join(ROOT, "portbench", "tests")
    code = (
        "import sys, time, pathlib\n"
        f"sys.path[:0] = [{ROOT!r}, {tests!r}]\n"
        "import torch; torch.set_num_threads(1)\n"
        "from conftest import tiny_spec\n"
        "from portbench import harness\n"
        "harness.prepare_env()\n"
        f"p = pathlib.Path({str(tmp_path)!r})\n"
        "for wl in ('stream-quality-720p', 'train-fast-b32'):\n"
        "    harness.run_cell(tiny_spec(p, wl), 7, 0.3, False, 'cpu',\n"
        "                     time.monotonic())\n"
        "print('FOUND', harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND []" in out.stdout


def test_refuses_without_a_card(tmp_path):
    """On a machine without the cell's cards the run exits non-zero and
    prints no result."""
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", "train-fast-b32", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
