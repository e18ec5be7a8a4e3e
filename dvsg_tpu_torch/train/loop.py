"""Self-supervised training loop on synthetic-jitter clips.

Loss: masked pixel L2 between the warped unstable frame and the
ground-truth target, direct regression to the known stabilizing offsets,
temporal smoothness between consecutive frame grids, and an
offset-magnitude regularizer. The loss warp is differentiable with respect
to its grid only (ops/warp.py::warp_batch_diff), which is all the pixel
term needs: frames are data.

All data is generated on the training device inside the step — no host
input pipeline. A step's draws come from a generator seeded by
(config seed, step), so a resumed run renders the batches the
uninterrupted one would have.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import torch

from dvsg_tpu_torch import resolve_device
from dvsg_tpu_torch.config import TrainConfig
from dvsg_tpu_torch.models import motion_cnn
from dvsg_tpu_torch.ops import grid as grid_ops
from dvsg_tpu_torch.ops import warp as warp_ops
from dvsg_tpu_torch.train import synthetic

# Consecutive windows per sample for the temporal-smoothness term.
_STEPS_PER_CLIP = 2
# Fraction of the border excluded from pixel loss (jitter makes the
# outermost band unrecoverable under border-clamped sampling).
_LOSS_BORDER = 0.125


@dataclasses.dataclass
class TrainState:
    """Model, optimizer and schedule of a run; ``step`` counts the updates
    taken."""
    model: motion_cnn.MotionEstimator
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0

    @property
    def params(self) -> dict:
        """The model's state dict (live tensors on the training device)."""
        return self.model.state_dict()


def learning_rate_at(cfg: TrainConfig, count: int) -> float:
    """Warmup-cosine schedule: linear 0 → peak over ``warmup`` updates,
    then a cosine to 0.05 * peak at max(steps, warmup + 1)."""
    warmup = min(cfg.warmup_steps, max(cfg.steps // 10, 1))
    decay_steps = max(cfg.steps, warmup + 1)
    peak = cfg.learning_rate
    if count < warmup:
        return peak * count / warmup
    frac = min(count - warmup, decay_steps - warmup) / (decay_steps - warmup)
    cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
    return peak * ((1.0 - 0.05) * cosine + 0.05)


def make_optimizer(cfg: TrainConfig, params, start: int = 0):
    """AdamW over every parameter (no decay mask) with the warmup-cosine
    schedule as a ``LambdaLR`` on a base rate of 1: the update the
    reference's ``adamw(schedule, weight_decay)`` makes. The schedule is
    read at the count of updates already taken, so the first update has
    rate 0; ``start`` is that count for a run that resumes. Returns
    (optimizer, scheduler)."""
    opt = torch.optim.AdamW(params, lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: learning_rate_at(cfg, start + count))
    return opt, sched


def build_state(cfg: TrainConfig, params: dict, device="cuda",
                step: int = 0) -> TrainState:
    """A TrainState around the given weights with a fresh optimizer and
    the schedule positioned at ``step`` updates."""
    device = resolve_device(device)
    model = motion_cnn.MotionEstimator(cfg.model)
    model.load_state_dict(params)
    model.to(device).train()
    opt, sched = make_optimizer(cfg, model.parameters(), start=step)
    return TrainState(model, opt, sched, step)


def init_state(cfg: TrainConfig, generator: torch.Generator,
               device="cuda") -> TrainState:
    return build_state(cfg, motion_cnn.init_params(cfg.model, generator),
                       device)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's draws, a function of (seed, step)."""
    # The CPU generator keeps 32 bits of its seed.
    return torch.Generator().manual_seed(
        (int(seed) * 1_000_003 + int(step) + 1) & 0xFFFFFFFF)


def _draw_stills(generator: torch.Generator, cfg: TrainConfig, bank,
                 device) -> torch.Tensor:
    """Base images for the batch: procedural noise, or random augmented
    draws from a real-footage bank (train/data.py) when one is given."""
    mh, mw = cfg.model.model_size
    b = cfg.batch_size
    if bank is None:
        return synthetic.random_still(generator, mh, mw, batch=(b,),
                                      device=device)
    gdev = generator.device
    idx = torch.randint(0, bank.shape[0], (b,), generator=generator,
                        device=gdev).to(bank.device)
    flips = (torch.rand((b, 2), generator=generator, device=gdev) < 0.5
             ).to(bank.device)
    img = bank[idx]
    img = torch.where(flips[:, 0, None, None, None], img.flip(2), img)
    img = torch.where(flips[:, 1, None, None, None], img.flip(1), img)
    return img.to(device)


def draw_batch(generator: torch.Generator, cfg: TrainConfig, bank=None,
               device="cpu"):
    """The random half of a batch: (stills (B, mh, mw, C), camera paths
    (B, clip_len, 5), flicker gains (B, clip_len)) on ``device``."""
    clip_len = cfg.model.window + _STEPS_PER_CLIP - 1
    b = cfg.batch_size
    stills = _draw_stills(generator, cfg, bank, device)
    paths = synthetic.random_camera_path(generator, clip_len, batch=(b,),
                                         device=device)
    gains = 1.0 + 0.03 * (2.0 * torch.rand(
        (b, clip_len), generator=generator, device=generator.device) - 1.0)
    return stills, paths, gains.to(device)


@torch.no_grad()
def render_batch(stills: torch.Tensor, paths: torch.Tensor,
                 gains: torch.Tensor, cfg: TrainConfig):
    """The deterministic half: render a batch of short clips at model
    resolution from its draws.

    Per window (ending at frame t) the learnable target is the warp taking
    frame t to the WINDOW-MEAN camera position
    (synthetic.stabilizing_theta) — the still's absolute position is
    unobservable from a short window, so supervision is window-relative.

    All jittered and all target frames are rendered by ONE warp call
    (ops/warp.py::warp_batch); everything here is data, so it runs without
    gradient.

    Returns (input_frames (B, clip_len, mh, mw, C) — flickered, centered
    at 0, lasts (B, S, mh, mw, C), target_frames (B, S, mh, mw, C),
    target_offsets (B, S, gh, gw, 2)) with S = _STEPS_PER_CLIP.
    """
    mcfg = cfg.model
    mh, mw = mcfg.model_size
    gh, gw = mcfg.grid_size
    n = mcfg.window
    s_steps = _STEPS_PER_CLIP
    b, clip_len = paths.shape[:2]

    # Window-mean poses and ground-truth stabilizing offsets per step.
    win_paths = torch.stack([paths[:, s:s + n] for s in range(s_steps)],
                            dim=1)                               # (B,S,n,5)
    mean_params = win_paths.mean(dim=2)                          # (B,S,5)
    t_offs = synthetic.theta_to_offsets(
        synthetic.stabilizing_theta(win_paths), gh, gw)

    all_thetas = torch.cat([
        synthetic.jitter_theta(paths).reshape(-1, 3, 3),
        synthetic.jitter_theta(mean_params).reshape(-1, 3, 3)])
    all_grids = grid_ops.homography_grid(all_thetas, mh, mw)
    src = torch.cat([stills.repeat_interleave(clip_len, dim=0),
                     stills.repeat_interleave(s_steps, dim=0)])
    warped = warp_ops.warp_batch(src, all_grids)
    frames = warped[:b * clip_len].reshape(b, clip_len, mh, mw, -1)
    t_frames = warped[b * clip_len:].reshape(b, s_steps, mh, mw, -1)

    # Photometric flicker on the model's INPUT frames only: motion
    # estimation must be exposure-robust; the frame being warped and the
    # targets stay clean (a stabilizer doesn't correct exposure).
    flicked = frames * gains[..., None, None, None] - 0.5
    lasts = frames[:, n - 1:]
    return flicked, lasts, t_frames, t_offs


def loss_from_batch(model: motion_cnn.MotionEstimator, batch,
                    cfg: TrainConfig):
    """(total, aux) of one rendered batch; differentiable with respect to
    the model's parameters."""
    in_frames, lasts, t_frames, t_offs = batch
    mh, mw = cfg.model.model_size
    n = cfg.model.window
    b, s = lasts.shape[:2]
    clip_len = in_frames.shape[1]

    # Encode each unique frame once; windows share window-1 frames.
    feats = motion_cnn.encode_frames(model, in_frames.flatten(0, 1))
    feats = feats.reshape(b, clip_len, *feats.shape[1:])
    fwins = torch.stack([feats[:, k:k + n] for k in range(s)], dim=1)
    offsets = motion_cnn.offsets_from_feature_windows(
        model, fwins.flatten(0, 1))
    grids = grid_ops.grid_from_offsets(offsets, mh, mw)
    # Grid-differentiable warp; frames are data, so grid-only gradients
    # are exactly what the loss needs.
    warped = warp_ops.warp_batch_diff(lasts.flatten(0, 1), grids)
    warped = warped.reshape(b, s, *warped.shape[1:])

    bh, bw = int(mh * _LOSS_BORDER), int(mw * _LOSS_BORDER)
    diff = warped - t_frames
    pixel = (diff[:, :, bh:mh - bh, bw:mw - bw, :] ** 2).mean()

    offs = offsets.reshape(b, s, *offsets.shape[1:])
    offset_l2 = ((offs - t_offs) ** 2).mean()
    smooth = ((offs[:, 1:] - offs[:, :-1]) ** 2).mean()
    reg = (offsets ** 2).mean()

    total = (cfg.pixel_weight * pixel + cfg.offset_weight * offset_l2
             + cfg.smooth_weight * smooth + cfg.reg_weight * reg)
    aux = {"pixel": pixel, "offset": offset_l2, "smooth": smooth,
           "reg": reg, "total": total}
    return total, aux


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def loss_fn(model: motion_cnn.MotionEstimator, generator: torch.Generator,
            cfg: TrainConfig, bank=None):
    device = _device_of(model)
    batch = render_batch(*draw_batch(generator, cfg, bank, device), cfg)
    return loss_from_batch(model, batch, cfg)


def train_step(state: TrainState, generator: torch.Generator,
               cfg: TrainConfig, bank=None) -> dict:
    """One update in place on ``state``; returns the loss terms (detached
    tensors on the training device)."""
    state.optimizer.zero_grad(set_to_none=True)
    total, aux = loss_fn(state.model, generator, cfg, bank)
    total.backward()
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return {k: v.detach() for k, v in aux.items()}


def train(cfg: TrainConfig, checkpoint_dir: Optional[str] = None,
          log_every: int = 50, state: Optional[TrainState] = None,
          print_fn=print, bank=None, device="cuda",
          history: Optional[list] = None) -> TrainState:
    """Run (or continue, from ``state``) the schedule to ``cfg.steps``.

    The configs are float32: cuDNN convolutions and cuBLAS matmuls are kept
    in full f32 (process-wide switches), so a card's losses can be held
    against the CPU's. ``history``, if given, receives every step's loss
    terms as floats (one device synchronize per step).
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if state is None:
        state = init_state(
            cfg, torch.Generator().manual_seed(cfg.seed), device)
    if bank is not None:        # upload once, reuse per step
        bank = torch.as_tensor(bank, dtype=torch.float32).to(
            _device_of(state.model))
    t0 = time.perf_counter()
    for step in range(state.step, cfg.steps):
        aux = train_step(state, step_generator(cfg.seed, step), cfg, bank)
        if history is not None:
            history.append({k: float(v) for k, v in aux.items()})
        if log_every and (step % log_every == 0 or step == cfg.steps - 1):
            a = {k: float(v) for k, v in aux.items()}
            print_fn(
                f"step {step:5d}  pixel={a['pixel']:.5f} "
                f"offset={a['offset']:.6f} smooth={a['smooth']:.6f} "
                f"reg={a['reg']:.6f} ({time.perf_counter() - t0:.1f}s)")
        if checkpoint_dir and cfg.checkpoint_every and (
                (step + 1) % cfg.checkpoint_every == 0
                or step == cfg.steps - 1):
            from dvsg_tpu_torch.utils import checkpoint as ckpt
            ckpt.save_checkpoint(checkpoint_dir, state.params, cfg.model,
                                 step=step + 1)
            # Full state too, so a resume restores optimizer moments and
            # schedule position instead of re-warming the rate.
            ckpt.save_train_state(checkpoint_dir, state, step=step + 1)
    return state


def load_train_state(cfg: TrainConfig, checkpoint_dir: str, device="cuda",
                     step: Optional[int] = None) -> TrainState:
    """Restore the full TrainState saved by train(); falls back to a
    params-only checkpoint (fresh optimizer, schedule positioned at its
    step) when no full state exists."""
    from dvsg_tpu_torch.utils import checkpoint as ckpt

    if step is not None or ckpt.latest_train_state_step(
            checkpoint_dir) is not None:
        saved, at = ckpt.load_train_state(checkpoint_dir, step)
        state = build_state(cfg, saved["params"], device, step=at)
        state.optimizer.load_state_dict(saved["optimizer"])
        return state
    params, mcfg, at = ckpt.load_checkpoint(checkpoint_dir)
    if mcfg != cfg.model:
        raise ValueError("checkpoint model config mismatch")
    return build_state(cfg, params, device, step=at)
