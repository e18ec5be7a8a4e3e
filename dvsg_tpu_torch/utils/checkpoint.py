"""Checkpoints: the reference's single-file ``.npz`` format, and training
checkpoint directories.

An ``.npz`` checkpoint holds one array per parameter of the reference
model, keyed by its ``/``-joined path (``encoder/res0_0/conv1/kernel``),
and the model config as JSON bytes under ``__config__``.
``params_from_flax`` maps such a flat dict onto the port's
``MotionEstimator`` state dict: conv kernels go from HWIO to OIHW,
GroupNorm ``scale`` becomes ``weight``; ``params_to_flax`` is the inverse,
and ``export_npz`` writes a file the reference's ``load_npz`` reads.

A training checkpoint directory holds ``model_config.json``,
``params/<step>.npz`` (the same single-file format) and
``train_state/<step>.pt`` (``torch.save`` of the weights, the optimizer's
moments and the step; the schedule and each step's random draws are
functions of the step, so nothing else is needed to resume).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from dvsg_tpu_torch.config import (ModelConfig, config_to_json,
                                   model_config_from_dict)

_CONFIG_FILE = "model_config.json"
_PARAMS_DIR = "params"
_STATE_DIR = "train_state"


def params_from_flax(flat: dict[str, np.ndarray], cfg: ModelConfig
                     ) -> dict[str, torch.Tensor]:
    """Flat reference params (``/``-joined paths → arrays) → the state dict of
    ``MotionEstimator(cfg)``. Raises on a missing, extra or misshapen
    parameter."""
    from dvsg_tpu_torch.models.motion_cnn import MotionEstimator
    target = MotionEstimator(cfg).state_dict()
    out = {}
    for path, arr in flat.items():
        *mods, leaf = path.split("/")
        arr = np.asarray(arr, np.float32)
        if leaf == "kernel":
            name, arr = "weight", arr.transpose(3, 2, 0, 1)   # HWIO → OIHW
        elif leaf == "scale":
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        else:
            raise KeyError(f"unexpected parameter {path}")
        key = ".".join(mods + [name])
        if key not in target:
            raise KeyError(f"checkpoint parameter {path} has no "
                           f"counterpart {key} in the model")
        if tuple(arr.shape) != tuple(target[key].shape):
            raise ValueError(f"shape mismatch for {path}: {arr.shape} "
                             f"vs {tuple(target[key].shape)}")
        out[key] = torch.from_numpy(np.array(arr, order="C"))  # own copy
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"checkpoint missing parameters {missing}")
    return out


def load_npz(path: str) -> tuple[dict[str, torch.Tensor], ModelConfig]:
    """Load an ``.npz`` checkpoint → (state dict on the CPU, ModelConfig)."""
    with np.load(path) as data:
        cfg = model_config_from_dict(
            json.loads(bytes(data["__config__"].tobytes()).decode()))
        flat = {k: data[k] for k in data.files if k != "__config__"}
    return params_from_flax(flat, cfg), cfg


def params_to_flax(params: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The inverse of ``params_from_flax``: a ``MotionEstimator`` state dict
    → flat reference params (OIHW → HWIO, ``weight`` → ``kernel`` for a
    conv, ``scale`` for a GroupNorm)."""
    flat = {}
    for key, t in params.items():
        *mods, leaf = key.split(".")
        arr = t.detach().cpu().numpy()
        if leaf == "weight" and arr.ndim == 4:
            name, arr = "kernel", arr.transpose(2, 3, 1, 0)   # OIHW → HWIO
        elif leaf == "weight":
            name = "scale"
        elif leaf == "bias":
            name = "bias"
        else:
            raise KeyError(f"unexpected parameter {key}")
        flat["/".join(mods + [name])] = np.ascontiguousarray(arr)
    return flat


def export_npz(path: str, params: dict[str, torch.Tensor],
               cfg: ModelConfig) -> None:
    """Single-file checkpoint in the reference's format: one array per
    parameter under its ``/``-joined path, the config as JSON bytes."""
    arrays = params_to_flax(params)
    arrays["__config__"] = np.frombuffer(config_to_json(cfg).encode(),
                                         dtype=np.uint8)
    with open(path, "wb") as f:       # a file object: no ".npz" appended
        np.savez_compressed(f, **arrays)


def _latest(path: str, sub: str, ext: str) -> Optional[int]:
    d = os.path.join(os.path.abspath(path), sub)
    if not os.path.isdir(d):
        return None
    steps = [int(n[:-len(ext)]) for n in os.listdir(d)
             if n.endswith(ext) and n[:-len(ext)].isdigit()]
    return max(steps) if steps else None


def save_checkpoint(path: str, params: dict[str, torch.Tensor],
                    cfg: ModelConfig, step: int = 0) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.join(path, _PARAMS_DIR), exist_ok=True)
    export_npz(os.path.join(path, _PARAMS_DIR, f"{step}.npz"), params, cfg)
    with open(os.path.join(path, _CONFIG_FILE), "w") as f:
        f.write(config_to_json(cfg))
        f.write("\n")


def latest_step(path: str) -> Optional[int]:
    return _latest(path, _PARAMS_DIR, ".npz")


def load_checkpoint(path: str, step: Optional[int] = None
                    ) -> tuple[dict[str, torch.Tensor], ModelConfig, int]:
    """Returns (state dict on the CPU, model config, step)."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no params checkpoints under {path}")
    params, cfg = load_npz(os.path.join(os.path.abspath(path), _PARAMS_DIR,
                                        f"{step}.npz"))
    return params, cfg, step


def save_train_state(path: str, state, step: int) -> None:
    """Save the FULL training state (weights, optimizer moments and step;
    the schedule's position is a function of the step) of a
    ``train.loop.TrainState``, so a resumed run keeps its moments and
    schedule instead of re-warming the rate."""
    d = os.path.join(os.path.abspath(path), _STATE_DIR)
    os.makedirs(d, exist_ok=True)
    cpu = lambda t: t.detach().cpu() if torch.is_tensor(t) else t
    opt = state.optimizer.state_dict()
    opt = {"state": {k: {n: cpu(v) for n, v in s.items()}
                     for k, s in opt["state"].items()},
           "param_groups": opt["param_groups"]}
    tmp = os.path.join(d, f"{step}.pt.tmp")
    torch.save({"params": {k: cpu(v) for k, v in state.params.items()},
                "optimizer": opt, "step": int(step)},
               tmp)
    os.replace(tmp, os.path.join(d, f"{step}.pt"))


def latest_train_state_step(path: str) -> Optional[int]:
    return _latest(path, _STATE_DIR, ".pt")


def load_train_state(path: str, step: Optional[int] = None
                     ) -> tuple[dict, int]:
    """Restore a ``save_train_state`` record → (dict with ``params``,
    ``optimizer``, ``step``; step)."""
    if step is None:
        step = latest_train_state_step(path)
        if step is None:
            raise FileNotFoundError(
                f"no train_state checkpoints under {path}")
    saved = torch.load(os.path.join(os.path.abspath(path), _STATE_DIR,
                                    f"{step}.pt"),
                       map_location="cpu", weights_only=True)
    return saved, step
