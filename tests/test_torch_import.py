"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its entry points run on the card unless the caller asks for the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import dvsg_tpu_torch
from dvsg_tpu_torch.config import ModelConfig, StabilizeConfig
from dvsg_tpu_torch.models.motion_cnn import MotionEstimator
from dvsg_tpu_torch.pipeline.stabilize import Stabilizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def _port_modules():
    """Every module of the port, found on disk, and the smoke script."""
    mods = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "dvsg_tpu_torch")):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(
                    ".__init__"))
    return sorted(mods) + ["chip_smoke"]


def _port_scripts():
    """The port's scripts and examples, by path."""
    ex = os.path.join(ROOT, "examples", "torch")
    return [os.path.join(ROOT, "scripts", "quality_table_torch.py")] + sorted(
        os.path.join(ex, f) for f in os.listdir(ex) if f.endswith(".py"))


_PROBE = """
import importlib, importlib.util, sys
for mod in {mods!r}:
    importlib.import_module(mod)
for i, path in enumerate({scripts!r}):
    spec = importlib.util.spec_from_file_location(f"_script{{i}}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "dvsg_tpu"))
print(",".join(bad))
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    mods = _port_modules()
    assert "dvsg_tpu_torch.train.loop" in mods and len(mods) > 20
    assert {f"dvsg_tpu_torch.pipeline.{m}" for m in
            ("pathsmooth", "autocrop", "online", "overlap", "batching",
             "multiclip")} <= set(mods)
    assert {"dvsg_tpu_torch.parallel.dp", "dvsg_tpu_torch.serve",
            "dvsg_tpu_torch.parallel.mesh", "dvsg_tpu_torch.parallel.temporal",
            "dvsg_tpu_torch.parallel.dryrun", "dvsg_tpu_torch.export",
            "dvsg_tpu_torch.utils.profiling", "dvsg_tpu_torch.parallel.tp",
            "dvsg_tpu_torch.native.build",
            "dvsg_tpu_torch.utils.staging"} <= set(mods)
    scripts = _port_scripts()
    assert len(scripts) == 8
    res = subprocess.run([sys.executable, "-c",
                          _PROBE.format(mods=mods, scripts=scripts)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", f"imported: {res.stdout.strip()}"


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_refuses_outside_the_repo(tmp_path):
    import shutil
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dvsg_tpu_torch.resolve_device()
    mcfg = ModelConfig(window=3, model_size=(32, 32), grid_size=(8, 8),
                       base_features=8, blocks_per_level=1)
    params = MotionEstimator(mcfg).state_dict()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Stabilizer(StabilizeConfig(model=mcfg), params)
    assert Stabilizer(StabilizeConfig(model=mcfg), params,
                      device="cpu").device.type == "cpu"


@pytest.mark.parametrize("device", ["mps", "meta"])
def test_unsupported_device_rejected(device):
    with pytest.raises(ValueError, match="unsupported device"):
        dvsg_tpu_torch.resolve_device(device)


@pytest.mark.parametrize("kw", [dict(path_smooth=8),
                                dict(path_smooth=8, path_smooth_lag=4)])
def test_path_smoothing_runs_on_the_cpu(kw):
    """A smoothing config (causal or fixed-lag) builds a CPU Stabilizer and
    stabilizes a clip, carrying its smoothing state."""
    mcfg = ModelConfig(window=3, model_size=(32, 32), grid_size=(8, 8),
                       base_features=8, blocks_per_level=1)
    params = MotionEstimator(mcfg).state_dict()
    stab = Stabilizer(StabilizeConfig(model=mcfg, chunk_frames=4, **kw),
                      params, device="cpu")
    frames = np.random.default_rng(0).integers(0, 256, (6, 32, 40, 3),
                                               dtype=np.uint8)
    out = stab.stabilize_clip(frames)
    assert out.shape == frames.shape and out.dtype == np.uint8
    assert stab.chunks_seen == 2 + (kw.get("path_smooth_lag", 0) > 0)


def test_config_dict_roundtrip_matches_reference():
    """A reference-format config dict (lists for tuples) loads into the
    port's dataclasses."""
    import dataclasses
    from dvsg_tpu_torch.config import stabilize_config_from_dict
    d = {"model": {"window": 3, "model_size": [64, 64],
                   "grid_size": [8, 8]},
         "chunk_frames": 4, "border_crop": 0.1, "strength": 0.5}
    cfg = stabilize_config_from_dict(d)
    assert cfg.model.model_size == (64, 64)
    assert dataclasses.asdict(cfg)["border_crop"] == 0.1
    with pytest.raises(ValueError):
        StabilizeConfig(border_crop=0.5)
    with pytest.raises(ValueError):
        StabilizeConfig(strength=np.float32(2.5))


def test_no_source_of_the_port_names_jax_modules():
    """No import statement of the port or the smoke script names a JAX-side
    module."""
    import re
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|flax|optax|orbax|"
                     r"dvsg_tpu)(?:[.\s]|$)", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")] + _port_scripts()
    for dirpath, _, files in os.walk(os.path.join(ROOT, "dvsg_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            hit = pat.search(f.read())
        assert hit is None, f"{path}: {hit.group(0).strip()}"


@pytest.mark.parametrize("command", ["train", "eval"])
def test_train_and_eval_default_to_the_card(command, tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    args = ["--checkpoint", str(tmp_path / "c"), "--steps", "1"] \
        if command == "train" else ["--clips", "1", "--frames", "4"]
    res = subprocess.run([sys.executable, "-m", "dvsg_tpu_torch", command,
                          *args], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert "pass device='cpu'" in res.stderr


def test_quality_table_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run([sys.executable, os.path.join(
        ROOT, "scripts", "quality_table_torch.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "pass device='cpu'" in res.stderr


def _resolve(name: str):
    """The object a dotted ``dvsg_tpu_torch`` name stands for: the longest
    importable module prefix, then attributes."""
    import importlib
    parts = name.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ImportError(name)


@pytest.mark.parametrize("doc", ["API.md", "DEPLOY.md"])
def test_docs_cite_only_what_the_port_has(doc):
    """Every ``dvsg_tpu_torch`` name in the port's docs (a dotted name in
    backticks, a call's arguments dropped) resolves, and every file of the
    package it names exists."""
    import re
    with open(os.path.join(ROOT, "docs", "torch", doc)) as f:
        text = f.read()
    names = set(re.findall(r"`(dvsg_tpu_torch(?:\.\w+)+)", text))
    paths = set(re.findall(r"(dvsg_tpu_torch/[\w/]+\.\w+)", text))
    assert len(names) > (50 if doc == "API.md" else 10)
    for name in sorted(names):
        _resolve(name)
    for path in sorted(paths):
        assert os.path.isfile(os.path.join(ROOT, path)), path
