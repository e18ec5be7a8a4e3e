"""dvsg_tpu_torch: the video stabilizer in PyTorch, with its warp kernels
written in CUDA for Hopper (sm_90a).

The layout mirrors ``dvsg_tpu`` (``ops/``, ``models/``, ``pipeline/``,
``utils/``); public functions keep its array layouts (NHWC uint8 frames,
``(B, gh, gw, 2)`` offsets in normalized (x, y) units). Entry points run on
the CUDA device unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

from dvsg_tpu_torch.config import (  # noqa: F401
    ModelConfig,
    StabilizeConfig,
    TrainConfig,
)

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    A CUDA device is only ever what the caller asked for: with no card the
    default raises instead of quietly running on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
