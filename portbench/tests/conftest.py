"""Tiny cells for the benchmark's CPU tests: a small model with random
weights in a checkpoint file of the port's format, and traffic cut to a
few frames, driven through the same harness and drivers as the card."""

import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

TINY_MODEL = {"arch": "corr", "base_features": 8, "blocks_per_level": 1,
              "channels": 3, "corr_radius": 1, "dtype": "float32",
              "grid_size": [8, 8], "levels": 4, "max_offset": 0.2,
              "model_size": [32, 32], "window": 3}


def tiny_checkpoint(path: str, seed: int = 0) -> str:
    """Random weights of ``TINY_MODEL`` in the checkpoint format (a head
    that moves pixels)."""
    from portbench.metrics import _work
    rng = np.random.default_rng(seed)
    convs, feats = _work._encoder_convs(TINY_MODEL)
    names = ["encoder/stem"]
    lv, h = 0, TINY_MODEL["model_size"][0]
    while h != TINY_MODEL["grid_size"][0]:
        names.append(f"encoder/down{lv}")
        names += [f"encoder/res{lv}_0/conv1", f"encoder/res{lv}_0/conv2"]
        lv, h = lv + 1, h // 2
    names += ["head_conv1", "head_conv2", "head_out"]
    arrays = {}
    for name, (cin, cout, k, _, _) in zip(
            names, convs + _work._head_convs(TINY_MODEL, feats)):
        arrays[name + "/kernel"] = (rng.standard_normal((k, k, cin, cout))
                                    / np.sqrt(k * k * cin)).astype(np.float32)
        arrays[name + "/bias"] = (0.01 * rng.standard_normal(cout)).astype(
            np.float32)
        if "/res" in name:
            gn = name.replace("conv", "gn")
            arrays[gn + "/scale"] = np.ones(cout, np.float32)
            arrays[gn + "/bias"] = np.zeros(cout, np.float32)
    arrays["__config__"] = np.frombuffer(json.dumps(TINY_MODEL).encode(),
                                         np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return path


def tiny_spec(tmp_path, workload: str) -> harness.Spec:
    """The manifest's cell ``workload`` with its model and traffic cut to
    a size the CPU runs in seconds."""
    spec = harness.load_spec(workload)
    spec.config = dict(spec.config, model=TINY_MODEL,
                       checkpoint=tiny_checkpoint(str(tmp_path / "t.npz")))
    t = dict(spec.traffic)
    if t["kind"] == "stream":
        t.update(height=48, width=64, chunk_frames=4, ring_chunks=3,
                 octaves=[[4, 0.5], [16, 0.2]], edge_octave=4)
    else:
        t.update(batch_size=2 * int(t.get("ranks", 1)), learning_rate=1e-3,
                 warmup_steps=1, steps=10)
    spec.traffic = t
    return spec


@pytest.fixture
def tiny(tmp_path):
    return lambda workload: tiny_spec(tmp_path, workload)
