"""Motion-estimation CNN (corr arch): sliding frame window → coarse offsets.

A siamese per-frame encoder (stem conv + stride-2 ResBlock pyramid down to
the coarse grid), PWC-style local correlation volumes of every window
frame against the last one, and a small float32 regression head.

Parameter names follow the reference checkpoints' paths
(``encoder.stem``, ``encoder.down{l}``, ``encoder.res{l}_{b}.conv1``,
``head_conv1``, ...; see utils/checkpoint.py). Three details of the
reference that differ from PyTorch defaults:

* ``SAME`` padding pads a stride-2 3×3 conv on an even input by (0, 1),
  not (1, 1): ``SameConv2d`` pads as the reference does;
* its GELU is the tanh approximation;
* its GroupNorm has epsilon 1e-6 (8 groups here).

Public functions keep the reference's NHWC layouts.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from dvsg_tpu_torch.config import ModelConfig

GN_GROUPS = 8
GN_EPS = 1e-6


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """(low, high) padding of XLA's ``SAME`` along one axis: output
    ceil(n / s), the odd pixel of padding goes at the high end."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """Conv2d (NCHW) with the reference's ``padding="SAME"``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride=stride, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        ph = same_pads(x.shape[-2], k, s)
        pw = same_pads(x.shape[-1], k, s)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, self.weight, self.bias, s, (ph[0], pw[0]))
        return super().forward(F.pad(x, (pw[0], pw[1], ph[0], ph[1])))


def _group_norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(GN_GROUPS, c, eps=GN_EPS)


class ResBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = SameConv2d(features, features, 3)
        self.gn1 = _group_norm(features)
        self.conv2 = SameConv2d(features, features, 3)
        self.gn2 = _group_norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = gelu(self.gn1(self.conv1(x)))
        h = self.gn2(self.conv2(h))
        return gelu(x + h)


def pyramid_levels(cfg: ModelConfig) -> int:
    """Stride-2 stages from model_size down to grid_size (the reference's
    ``_stem_pyramid`` loop)."""
    mh, mw = cfg.model_size
    down, level = 1, 0
    while (mh // down, mw // down) != tuple(cfg.grid_size) \
            and level < cfg.levels * 2:
        down *= 2
        level += 1
    if (mh // down, mw // down) != tuple(cfg.grid_size):
        raise ValueError(
            f"cannot reach grid_size {cfg.grid_size} from "
            f"model_size {cfg.model_size} by stride-2 stages")
    return level


class FrameEncoder(nn.Module):
    """Per-frame encoder: NCHW (B, C, Hm, Wm) → (B, F, gh, gw)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        feats = cfg.base_features
        self.stem = SameConv2d(cfg.channels, feats, 7)
        self.n_levels = pyramid_levels(cfg)
        self.blocks_per_level = cfg.blocks_per_level
        for level in range(self.n_levels):
            nxt = min(feats * 2, 256)
            self.add_module(f"down{level}", SameConv2d(feats, nxt, 3, 2))
            for b in range(cfg.blocks_per_level):
                self.add_module(f"res{level}_{b}", ResBlock(nxt))
            feats = nxt
        self.out_features = feats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = gelu(self.stem(x))
        for level in range(self.n_levels):
            x = gelu(getattr(self, f"down{level}")(x))
            for b in range(self.blocks_per_level):
                x = getattr(self, f"res{level}_{b}")(x)
        return x


def correlation_volume(ref: torch.Tensor, other: torch.Tensor,
                       radius: int) -> torch.Tensor:
    """Local cost volumes, NCHW: ref (B, F, gh, gw) against each of
    other (B, K, F, gh, gw) → (B, K, (2r+1)^2, gh, gw). Channel
    dy * (2r+1) + dx holds sum_f ref * other[shifted by (dy - r, dx - r)]
    * F^-0.5, with ``other`` zero-padded by ``radius``."""
    f, gh, gw = ref.shape[-3:]
    k = 2 * radius + 1
    pad = F.pad(other, (radius, radius, radius, radius))
    ref = ref[:, None]
    vols = [(ref * pad[..., dy:dy + gh, dx:dx + gw]).sum(dim=2)
            for dy in range(k) for dx in range(k)]
    return torch.stack(vols, dim=2) * (float(f) ** -0.5)


class MotionEstimator(nn.Module):
    """Corr-arch motion CNN; the parameter tree of one checkpoint."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.arch != "corr":
            raise NotImplementedError(
                f"arch {cfg.arch!r} is not ported yet (corr only)")
        if cfg.dtype != "float32":
            raise NotImplementedError(
                f"dtype {cfg.dtype!r} is not ported yet (float32 only)")
        self.cfg = cfg
        self.encoder = FrameEncoder(cfg)
        n_corr = (cfg.window - 1) * (2 * cfg.corr_radius + 1) ** 2
        self.head_conv1 = SameConv2d(n_corr + self.encoder.out_features,
                                     128, 3)
        self.head_conv2 = SameConv2d(128, 128, 3)
        self.head_out = SameConv2d(128, 2, 3)

    def head(self, feats: torch.Tensor) -> torch.Tensor:
        """Correlation volumes + regression head, NCHW: feats
        (B, N, F, gh, gw) → offsets (B, 2, gh, gw)."""
        cfg = self.cfg
        n = cfg.window
        b, _, _, gh, gw = feats.shape
        ref = feats[:, -1]                  # the frame being stabilized
        if n > 1:
            vols = correlation_volume(ref, feats[:, :-1], cfg.corr_radius)
            # window frame k's (2r+1)^2 channels, in order, then ref
            x = torch.cat([vols.reshape(b, -1, gh, gw), ref], dim=1)
        else:
            x = ref
        x = gelu(self.head_conv1(x.to(torch.float32)))
        x = gelu(self.head_conv2(x))
        return torch.tanh(self.head_out(x)) * cfg.max_offset


# Standard deviation of a unit normal truncated to [-2, 2]: the reference's
# default kernel initializer divides by it so the truncated draw has
# variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def init_params(cfg: ModelConfig, generator: torch.Generator
                ) -> dict[str, torch.Tensor]:
    """A fresh state dict for ``MotionEstimator(cfg)``, drawn from
    ``generator`` as the reference initializes its model: conv kernels
    truncated normal (±2 sigma) with variance 1 / fan_in, biases zero,
    GroupNorm weight one, and a zero ``head_out`` kernel, so an untrained
    model predicts zero offsets (the identity warp)."""
    model = MotionEstimator(cfg)
    params = {}
    for name, p in model.state_dict().items():
        if name.endswith(".bias") or name == "head_out.weight":
            params[name] = torch.zeros_like(p)
        elif p.dim() == 1:                      # GroupNorm weight
            params[name] = torch.ones_like(p)
        else:                                   # conv kernel, OIHW
            fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            w = torch.empty(p.shape, dtype=p.dtype, device=generator.device)
            torch.nn.init.trunc_normal_(w, std=std, a=-2.0 * std,
                                        b=2.0 * std, generator=generator)
            params[name] = w.to(p.device)
    return params


def encode_frames(model: MotionEstimator, frames: torch.Tensor
                  ) -> torch.Tensor:
    """Per-frame encoder pass: frames (B, Hm, Wm, C) → features
    (B, gh, gw, F).

    Sliding windows share window-1 of their frames, so callers encode each
    unique frame once and assemble feature windows.
    """
    x = frames.to(torch.float32).permute(0, 3, 1, 2).contiguous()
    return model.encoder(x).permute(0, 2, 3, 1)


def offsets_from_feature_windows(model: MotionEstimator,
                                 feat_windows: torch.Tensor) -> torch.Tensor:
    """Head pass over cached features: (B, N, gh, gw, F) → offsets
    (B, gh, gw, 2) in normalized units, |offset| <= max_offset."""
    feats = feat_windows.permute(0, 1, 4, 2, 3).contiguous()
    return model.head(feats).permute(0, 2, 3, 1)
