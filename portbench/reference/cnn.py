"""The motion CNN in plain PyTorch and float32, for the ``corr`` arch.

A frame encoder (a 7x7 stem, then per level a stride-2 3x3 conv and
residual blocks of conv, GroupNorm, GELU) runs on every frame; the last
frame of each window is correlated with the others over a (2r + 1)^2
neighbourhood (PWC-Net's cost volume, scaled by F^-0.5); a three-conv
head regresses (dx, dy) per grid cell, ``tanh`` times ``max_offset``.

Conventions: ``SAME`` padding as XLA pads it (the odd pixel at the high
end), GELU in its tanh form, GroupNorm of 8 groups with epsilon 1e-6.
The parameters are the checkpoint's own arrays, keyed by their
``/``-joined paths, conv kernels kept as stored (HWIO) and transposed at
each call.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch
import torch.nn.functional as F

GROUPS = 8
EPS = 1e-6


def load_npz(path: str) -> tuple[dict, dict]:
    """(parameters by path as float32 CPU tensors, the model config dict)
    of a checkpoint file."""
    with np.load(path) as z:
        cfg = json.loads(bytes(z["__config__"].tobytes()).decode())
        params = {k: torch.from_numpy(np.array(z[k], np.float32))
                  for k in z.files if k != "__config__"}
    return params, cfg


def torch_name(path: str) -> str:
    """The state-dict name of a parameter path: ``a/b/kernel`` and
    ``a/b/scale`` are ``a.b.weight``, ``a/b/bias`` is ``a.b.bias``."""
    *mods, leaf = path.split("/")
    return ".".join(mods + ["bias" if leaf == "bias" else "weight"])


def torch_layout(path: str, t: torch.Tensor) -> torch.Tensor:
    """A parameter in the state-dict layout (conv kernels OIHW)."""
    return t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x * x * x)))


def _same(n: int, k: int, s: int) -> tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
         stride: int = 1) -> torch.Tensor:
    """NCHW conv with an HWIO kernel and SAME padding."""
    k = kernel.shape[0]
    (ht, hb), (wl, wr) = _same(x.shape[-2], k, stride), _same(
        x.shape[-1], k, stride)
    x = F.pad(x, (wl, wr, ht, hb))
    return F.conv2d(x, kernel.permute(3, 2, 0, 1), bias, stride)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
               ) -> torch.Tensor:
    b, c, h, w = x.shape
    g = x.reshape(b, GROUPS, -1)
    mean = g.mean(dim=-1, keepdim=True)
    var = ((g - mean) ** 2).mean(dim=-1, keepdim=True)
    g = (g - mean) / torch.sqrt(var + EPS)
    return g.reshape(b, c, h, w) * scale[:, None, None] + bias[:, None, None]


def levels(cfg: dict) -> int:
    """Stride-2 stages from the model size down to the grid size."""
    (mh, mw), (gh, gw) = cfg["model_size"], cfg["grid_size"]
    n = 0
    while (mh >> n, mw >> n) != (gh, gw):
        n += 1
        if n > 2 * cfg["levels"]:
            raise ValueError("grid size not reached by halving")
    return n


def encode(p: dict, cfg: dict, frames: torch.Tensor) -> torch.Tensor:
    """Frames (B, mh, mw, C) → features NCHW (B, F, gh, gw)."""
    x = frames.permute(0, 3, 1, 2)
    x = gelu(conv(x, p["encoder/stem/kernel"], p["encoder/stem/bias"]))
    for lv in range(levels(cfg)):
        d = f"encoder/down{lv}/"
        x = gelu(conv(x, p[d + "kernel"], p[d + "bias"], 2))
        for blk in range(cfg["blocks_per_level"]):
            r = f"encoder/res{lv}_{blk}/"
            h = gelu(group_norm(conv(x, p[r + "conv1/kernel"],
                                     p[r + "conv1/bias"]),
                                p[r + "gn1/scale"], p[r + "gn1/bias"]))
            h = group_norm(conv(h, p[r + "conv2/kernel"], p[r + "conv2/bias"]),
                           p[r + "gn2/scale"], p[r + "gn2/bias"])
            x = gelu(x + h)
    return x


def head(p: dict, cfg: dict, feats: torch.Tensor) -> torch.Tensor:
    """Feature windows (B, N, F, gh, gw) → offsets (B, gh, gw, 2)."""
    b, n, f, gh, gw = feats.shape
    r = cfg["corr_radius"]
    ref = feats[:, -1]
    pad = F.pad(feats[:, :-1], (r, r, r, r))
    vols = [(ref[:, None] * pad[..., dy:dy + gh, dx:dx + gw]).sum(dim=2)
            for dy in range(2 * r + 1) for dx in range(2 * r + 1)]
    vols = torch.stack(vols, dim=2) * (float(f) ** -0.5)
    x = torch.cat([vols.reshape(b, -1, gh, gw), ref], dim=1)
    x = gelu(conv(x, p["head_conv1/kernel"], p["head_conv1/bias"]))
    x = gelu(conv(x, p["head_conv2/kernel"], p["head_conv2/bias"]))
    x = torch.tanh(conv(x, p["head_out/kernel"], p["head_out/bias"]))
    return (x * cfg["max_offset"]).permute(0, 2, 3, 1)


def window_offsets(p: dict, cfg: dict, seq: torch.Tensor, t: int
                   ) -> torch.Tensor:
    """Offsets (t, gh, gw, 2) of the t windows of a (t + N - 1)-frame
    model-resolution sequence: window i is frames i .. i + N - 1."""
    n = cfg["window"]
    feats = encode(p, cfg, seq)
    wins = torch.stack([feats[i:i + n] for i in range(t)])
    return head(p, cfg, wins)
