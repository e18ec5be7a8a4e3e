"""The self-supervised training step in plain PyTorch: draws, rendering,
loss, gradient and AdamW, for the first steps of a run.

A sample is a short clip rendered at the model's resolution from a
procedural still (noise octaves, bicubic upsampling, min-max normalized)
moved along a smooth random camera path (tx, ty, angle, px, py per frame,
as homographies on align-corners coordinates). Its targets are the still
moved to the mean pose of each window and the offsets that take a
window's last frame there. The loss is the masked pixel L2 of the last
frame warped by the predicted grid (differentiable in the grid only),
plus the offset L2 against the targets, a temporal smoothness term and an
offset regularizer. AdamW runs on a warmup-cosine schedule.

The draws follow one order on one CPU generator per step: the still's
octaves, the path's steps and magnitudes, the flicker gains.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import cnn, resize
from portbench.reference.stream import dense_grid, identity_grid, warp

OCTAVES = ((4, 0.5), (8, 0.25), (16, 0.15), (64, 0.10))
PATH_LEAD = 8
STEPS_PER_CLIP = 2
LOSS_BORDER = 0.125
POSE_BOUNDS = (0.08, 0.08, 0.05, 0.02, 0.02)
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
# Samples rendered and differentiated at once, so the reference fits on
# the card beside nothing else at the cells' batch.
BLOCK = 8


def draws(gen: torch.Generator, batch: int, mh: int, mw: int,
          clip_len: int):
    """(stills (B, mh, mw, 3), paths (B, clip_len, 5), gains
    (B, clip_len)) on the CPU."""
    coarse = [torch.rand((batch, res, res, 3), generator=gen)
              for res, _ in OCTAVES]
    steps = torch.randn((batch, clip_len + PATH_LEAD, 5), generator=gen)
    mag = 0.3 + 0.7 * torch.rand((batch, 5), generator=gen)
    gains = 1.0 + 0.03 * (2.0 * torch.rand((batch, clip_len), generator=gen)
                          - 1.0)
    return coarse, steps, mag, gains


def still(coarse, mh: int, mw: int) -> torch.Tensor:
    img = sum(amp * resize.resize(c, mh, mw, "cubic")
              for (_, amp), c in zip(OCTAVES, coarse))
    img = img - img.amin(dim=(-3, -2, -1), keepdim=True)
    return img / torch.clamp(img.amax(dim=(-3, -2, -1), keepdim=True),
                             min=1e-6)


def camera_path(steps: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    walk = torch.cumsum(steps, dim=-2)
    smooth = walk.unfold(-2, PATH_LEAD + 1, 1).sum(dim=-1) / float(
        PATH_LEAD + 1)
    smooth = smooth - smooth.mean(dim=-2, keepdim=True)
    peak = torch.clamp(smooth.abs().amax(dim=-2, keepdim=True), min=1e-6)
    bound = torch.tensor(POSE_BOUNDS, dtype=steps.dtype, device=steps.device)
    return smooth / peak * bound * mag[..., None, :]


def pose(params: torch.Tensor) -> torch.Tensor:
    """(..., 5) → (..., 3, 3) homographies."""
    tx, ty, a, px, py = params.unbind(dim=-1)
    c, s, one = torch.cos(a), torch.sin(a), torch.ones_like(tx)
    rows = [[c, -s, tx], [s, c, ty], [px, py, one]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def inverse(m: torch.Tensor) -> torch.Tensor:
    inv = torch.linalg.inv(m.double()).to(m.dtype)
    return inv / inv[..., 2:, 2:]


def homography_grid(m: torch.Tensor, h: int, w: int) -> torch.Tensor:
    base = identity_grid(h, w, m.device)
    homo = torch.cat([base, torch.ones_like(base[..., :1])], dim=-1)
    out = torch.einsum("hwk,...ck->...hwc", homo, m)
    return out[..., :2] / out[..., 2:]


@torch.no_grad()
def render(stills: torch.Tensor, paths: torch.Tensor, gains: torch.Tensor,
           cfg: dict):
    """(input frames (B, L, mh, mw, 3) flickered and centred, last frames
    (B, S, ...), target frames (B, S, ...), target offsets
    (B, S, gh, gw, 2))."""
    n = cfg["window"]
    mh, mw = cfg["model_size"]
    gh, gw = cfg["grid_size"]
    b, clip_len = paths.shape[:2]
    s = STEPS_PER_CLIP
    wins = torch.stack([paths[:, i:i + n] for i in range(s)], dim=1)
    mean = wins.mean(dim=2)
    fix = inverse(pose(wins[..., -1, :])) @ pose(mean)
    fix = fix / fix[..., 2:, 2:]
    t_offs = homography_grid(fix, gh, gw) - identity_grid(gh, gw,
                                                          fix.device)
    mats = torch.cat([pose(paths).reshape(-1, 3, 3),
                      pose(mean).reshape(-1, 3, 3)])
    src = torch.cat([stills.repeat_interleave(clip_len, dim=0),
                     stills.repeat_interleave(s, dim=0)])
    out = warp(src, homography_grid(mats, mh, mw))
    frames = out[:b * clip_len].reshape(b, clip_len, mh, mw, -1)
    targets = out[b * clip_len:].reshape(b, s, mh, mw, -1)
    inputs = frames * gains[..., None, None, None] - 0.5
    return inputs, frames[:, n - 1:], targets, t_offs


def loss(p: dict, cfg: dict, batch, weights: dict):
    """(total, terms) of a rendered batch; differentiable in ``p``."""
    inputs, lasts, targets, t_offs = batch
    n = cfg["window"]
    mh, mw = cfg["model_size"]
    b, s = lasts.shape[:2]
    feats = cnn.encode(p, cfg, inputs.flatten(0, 1))
    feats = feats.reshape(b, inputs.shape[1], *feats.shape[1:])
    wins = torch.stack([feats[:, i:i + n] for i in range(s)], dim=1)
    offsets = cnn.head(p, cfg, wins.flatten(0, 1))
    warped = warp(lasts.flatten(0, 1), dense_grid(offsets, mh, mw))
    warped = warped.reshape(b, s, *warped.shape[1:])
    bh, bw = int(mh * LOSS_BORDER), int(mw * LOSS_BORDER)
    terms = {"pixel": ((warped - targets)[:, :, bh:mh - bh, bw:mw - bw]
                       ** 2).mean()}
    offs = offsets.reshape(b, s, *offsets.shape[1:])
    terms["offset"] = ((offs - t_offs) ** 2).mean()
    terms["smooth"] = ((offs[:, 1:] - offs[:, :-1]) ** 2).mean()
    terms["reg"] = (offsets ** 2).mean()
    total = sum(weights[k] * terms[k] for k in ("pixel", "offset", "smooth",
                                               "reg"))
    return total, terms


def learning_rate(train: dict, count: int) -> float:
    """Linear warmup from 0, then a cosine to 5 % of the peak."""
    warmup = min(train["warmup_steps"], max(train["steps"] // 10, 1))
    decay = max(train["steps"], warmup + 1)
    peak = train["learning_rate"]
    if count < warmup:
        return peak * count / warmup
    frac = min(count - warmup, decay - warmup) / (decay - warmup)
    return peak * (0.95 * 0.5 * (1.0 + math.cos(math.pi * frac)) + 0.05)


def gradient(p: dict, cfg: dict, train: dict, gen: torch.Generator):
    """(loss terms, gradients) of one step's batch, computed over blocks
    of ``BLOCK`` samples (every term is a mean over equal blocks)."""
    mh, mw = cfg["model_size"]
    b = train["batch_size"]
    clip_len = cfg["window"] + STEPS_PER_CLIP - 1
    dev = next(iter(p.values())).device
    coarse, steps, mag, gains = draws(gen, b, mh, mw, clip_len)
    stills = still([c.to(dev) for c in coarse], mh, mw)
    paths = camera_path(steps.to(dev), mag.to(dev))
    gains = gains.to(dev)
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    terms_sum: dict = {}
    parts = range(0, b, BLOCK)
    for i in parts:
        sl = slice(i, i + BLOCK)
        batch = render(stills[sl], paths[sl], gains[sl], cfg)
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        total, terms = loss(leaves, cfg, batch, train["loss_weights"])
        g = torch.autograd.grad(total, list(leaves.values()))
        for k, gk in zip(leaves, g):
            grads[k] += gk / len(parts)
        terms["total"] = total
        for k, v in terms.items():
            terms_sum[k] = terms_sum.get(k, 0.0) + float(v.detach()) / len(
                parts)
    return terms_sum, grads


def first_steps(p0: dict, cfg: dict, train: dict, generators) -> dict:
    """Run len(generators) AdamW steps from ``p0``. Returns the readings:
    ``losses`` (total loss of each step), ``grad`` (each leaf's first
    gradient norm) and ``change`` (each leaf's norm of the parameters'
    change over the steps), leaves named as in the port's state dict."""
    p = {k: v.clone() for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2 = BETAS
    losses, grad_norm = [], {}
    for t, gen in enumerate(generators, start=1):
        terms, g = gradient(p, cfg, train, gen)
        losses.append(terms["total"])
        if t == 1:
            grad_norm = {cnn.torch_name(k): float(gk.norm())
                         for k, gk in g.items()}
        lr = learning_rate(train, t - 1)
        for k in p:
            p[k] = p[k] * (1.0 - lr * train["weight_decay"])
            m[k] = b1 * m[k] + (1.0 - b1) * g[k]
            v2[k] = b2 * v2[k] + (1.0 - b2) * g[k] * g[k]
            den = (v2[k].sqrt() / math.sqrt(1.0 - b2 ** t)) + ADAM_EPS
            p[k] = p[k] - (lr / (1.0 - b1 ** t)) * m[k] / den
    change = {cnn.torch_name(k): float((p[k] - p0[k]).norm()) for k in p}
    return {"losses": losses, "grad": grad_norm, "change": change}
