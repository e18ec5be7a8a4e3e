"""Checkpoint loading: the reference's single-file ``.npz`` format.

An ``.npz`` checkpoint holds one array per parameter of the reference
model, keyed by its ``/``-joined path (``encoder/res0_0/conv1/kernel``),
and the model config as JSON bytes under ``__config__``.
``params_from_flax`` maps such a flat dict onto the port's
``MotionEstimator`` state dict: conv kernels go from HWIO to OIHW,
GroupNorm ``scale`` becomes ``weight``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from dvsg_tpu_torch.config import ModelConfig, model_config_from_dict


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
