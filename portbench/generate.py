"""Inputs of every cell, made from the run's seed and its traffic file.

* ``shaky_clip``: a textured still (noise octaves upsampled bicubically,
  plus hard edges from thresholding one octave), moved along a smooth
  random camera path (translation, rotation, zoom per frame) and sampled
  into uint8 frames, all on the device with one generator there, in a few
  large calls. Every seed gives the same sizes and the same amount of
  work; only the content differs.
* ``step_generator``: a training step's CPU generator.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1
# Frames sampled from the still per call.
RENDER_BLOCK = 16


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of step ``step`` of a run seeded ``seed``, with a
    63-bit seed of its own for every (seed, step) pair."""
    return torch.Generator().manual_seed(
        ((int(seed) & _MASK) * 1_000_003 + (int(step) + 1) * _MIX) & _MASK)


def shaky_clip(traffic: dict, seed: int, device, frames: int
               ) -> torch.Tensor:
    """(frames, H, W, 3) uint8 on ``device``."""
    h, w = traffic["height"], traffic["width"]
    gen = torch.Generator(device=device).manual_seed(int(seed) & _MASK)
    still = torch.zeros((1, 3, h, w), device=device)
    for res, amp in traffic["octaves"]:
        coarse = torch.rand((1, 3, res, res), generator=gen, device=device)
        still += amp * F.interpolate(coarse, size=(h, w), mode="bicubic",
                                     align_corners=False)
        if res == traffic["edge_octave"]:
            edges = (coarse > 0.5).float()
            still += traffic["edge_amp"] * F.interpolate(
                edges, size=(h, w), mode="nearest")
    still -= still.amin()
    still /= still.amax()
    # A random walk, low-passed, per pose component: tx, ty (normalized
    # units), angle (radians), log-zoom.
    lead = traffic["path_smoothing"]
    steps = torch.randn((frames + lead, 4), generator=gen, device=device)
    walk = torch.cumsum(steps, dim=0).unfold(0, lead + 1, 1).mean(dim=-1)
    walk = walk[:frames] - walk[:frames].mean(dim=0)
    walk = walk / walk.abs().amax(dim=0).clamp(min=1e-6)
    pose = walk * torch.tensor(traffic["pose_bounds"], device=device)
    tx, ty, ang, zoom = pose.unbind(dim=-1)
    s = torch.exp(zoom) * (1.0 - 2.0 * traffic["margin"])
    theta = torch.stack([
        torch.stack([s * torch.cos(ang), -s * torch.sin(ang), tx], dim=-1),
        torch.stack([s * torch.sin(ang), s * torch.cos(ang), ty], dim=-1)],
        dim=-2)
    out = torch.empty((frames, h, w, 3), dtype=torch.uint8, device=device)
    for i in range(0, frames, RENDER_BLOCK):
        th = theta[i:i + RENDER_BLOCK]
        grid = F.affine_grid(th, (len(th), 3, h, w), align_corners=True)
        img = F.grid_sample(still.expand(len(th), -1, -1, -1), grid,
                            mode="bilinear", padding_mode="border",
                            align_corners=True)
        out[i:i + RENDER_BLOCK] = (img * 255.0).round().clamp(0, 255).to(
            torch.uint8).permute(0, 2, 3, 1)
    return out
