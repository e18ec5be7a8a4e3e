"""Synthetic shaky-clip generation: the reference-free ground-truth fixture.

Apply a known smooth camera jitter to a static image; the stabilizer should
invert it, so the still image itself is ground truth and PSNR is computable
without reference outputs. Also the training data source: the model is
self-trained on this distribution.

Affine jitter is linear in position, and the model's coarse offset grid is
bilinearly upsampled — a linear field is exactly representable, so the
model can in principle drive pixel loss to zero.

Every function that draws takes an explicit ``torch.Generator`` and draws
on the generator's device (a CPU generator gives the same clip whatever
the device the result is moved to). A CPU generator's draws bound for a
card are made in pinned memory (``draw_options``) and uploaded with
``non_blocking=True``: the upload is queued on the current stream and
waits neither for the card nor makes the host wait for it.
The deterministic functions take tensors with any leading batch axes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dvsg_tpu_torch.ops import grid as grid_ops
from dvsg_tpu_torch.ops import resize as resize_ops
from dvsg_tpu_torch.ops import warp as warp_ops

# (resolution, amplitude) of the still's noise octaves.
STILL_OCTAVES = ((4, 0.5), (8, 0.25), (16, 0.15), (64, 0.10))
# Random-walk steps beyond num_frames, consumed by the moving average.
_PATH_LEAD = 8
# Frames rendered per warp call (bounds the replicated still's memory).
_RENDER_CHUNK = 16


def draw_options(generator: torch.Generator, device) -> dict:
    """Factory arguments of a draw from ``generator`` bound for ``device``:
    on the generator's device, and in pinned memory where a CPU
    generator's draw goes to a card (the caching host allocator keeps the
    block until its upload is done)."""
    pin = (generator.device.type == "cpu"
           and torch.device(device).type == "cuda")
    return {"generator": generator, "device": generator.device,
            "pin_memory": pin}


def still_from_octaves(coarses, height: int, width: int) -> torch.Tensor:
    """The still (..., H, W, C) in [0, 1] from its uniform-noise octaves
    (one (..., res, res, C) tensor per entry of ``STILL_OCTAVES``): bicubic
    upsample, weighted sum, min-max normalization per image."""
    img = sum(amp * resize_ops.resize_bicubic(c, height, width)
              for (_, amp), c in zip(STILL_OCTAVES, coarses))
    img = img - img.amin(dim=(-3, -2, -1), keepdim=True)
    return img / torch.clamp(img.amax(dim=(-3, -2, -1), keepdim=True),
                             min=1e-6)


def random_still(generator: torch.Generator, height: int, width: int,
                 channels: int = 3, batch: Tuple[int, ...] = (),
                 device=None) -> torch.Tensor:
    """Procedural textured still image(s) in [0, 1]: multi-octave smooth
    noise, (*batch, H, W, C) on ``device``.

    Low-frequency octaves dominate so images have trackable large-scale
    structure (like real video), plus a fine octave for texture.
    """
    device = generator.device if device is None else device
    draw = draw_options(generator, device)
    coarses = [torch.rand((*batch, res, res, channels), **draw).to(
        device, non_blocking=True) for res, _ in STILL_OCTAVES]
    return still_from_octaves(coarses, height, width)


@resize_ops.tensor_cache(maxsize=16)
def _path_scale(max_trans: float, max_angle: float, max_persp: float,
                dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The path's per-component bounds on ``device``, uploaded once: a
    list's upload waits for the card."""
    # Cached past its first caller, which may run under inference_mode.
    with torch.inference_mode(False):
        return torch.tensor([max_trans, max_trans, max_angle, max_persp,
                             max_persp], dtype=dtype, device=device)


def camera_path_from_draws(steps: torch.Tensor, mag: torch.Tensor,
                           max_trans: float = 0.08, max_angle: float = 0.05,
                           max_persp: float = 0.02) -> torch.Tensor:
    """The camera path (..., T, 5) from its draws: normal ``steps``
    (..., T + 8, 5) and uniform magnitudes ``mag`` (..., 5) in [0.3, 1].

    A random walk low-passed with a 9-frame moving average, centered, and
    scaled so each component peaks at its bound times its magnitude.
    """
    walk = torch.cumsum(steps, dim=-2)
    smooth = walk.unfold(-2, _PATH_LEAD + 1, 1).sum(dim=-1) \
        / float(_PATH_LEAD + 1)
    smooth = smooth - smooth.mean(dim=-2, keepdim=True)
    denom = torch.clamp(smooth.abs().amax(dim=-2, keepdim=True), min=1e-6)
    scale = _path_scale(max_trans, max_angle, max_persp, steps.dtype,
                        steps.device)
    return smooth / denom * scale * mag[..., None, :]


def random_camera_path(generator: torch.Generator, num_frames: int,
                       max_trans: float = 0.08, max_angle: float = 0.05,
                       max_persp: float = 0.02,
                       batch: Tuple[int, ...] = (),
                       device=None) -> torch.Tensor:
    """Smooth random camera shake: per-frame (tx, ty, angle, px, py),
    (*batch, num_frames, 5).

    tx/ty in normalized units (align_corners grid units), angle in radians,
    px/py mild projective terms (perspective wobble). The low-frequency
    handheld-shake regime the stabilizer is meant to remove.
    """
    device = generator.device if device is None else device
    draw = draw_options(generator, device)
    steps = torch.randn((*batch, num_frames + _PATH_LEAD, 5), **draw)
    # 0.3 + 0.7 * u, in place so that it stays in the draw's memory.
    mag = torch.rand((*batch, 5), **draw).mul_(0.7).add_(0.3)
    return camera_path_from_draws(steps.to(device, non_blocking=True),
                                  mag.to(device, non_blocking=True),
                                  max_trans, max_angle, max_persp)


def _matrix(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def jitter_theta(params: torch.Tensor) -> torch.Tensor:
    """(..., 5) of (tx, ty, angle, px, py) → (..., 3, 3) homographies in
    normalized coords."""
    tx, ty, ang, px, py = params.unbind(dim=-1)
    ca, sa = torch.cos(ang), torch.sin(ang)
    return _matrix([[ca, -sa, tx], [sa, ca, ty],
                    [px, py, torch.ones_like(tx)]])


def similarity_theta(params: torch.Tensor) -> torch.Tensor:
    """(..., 4) of (tx, ty, angle, log_scale) → (..., 3, 3) similarities in
    normalized coords (the zoom-sway fixture; log-scale composes
    additively like the other pose components)."""
    tx, ty, ang, logs = params.unbind(dim=-1)
    s = torch.exp(logs)
    ca, sa = s * torch.cos(ang), s * torch.sin(ang)
    zero, one = torch.zeros_like(tx), torch.ones_like(tx)
    return _matrix([[ca, -sa, tx], [sa, ca, ty], [zero, zero, one]])


def invert_theta(hmat: torch.Tensor) -> torch.Tensor:
    """Invert 3x3 homographies (..., 3, 3), normalized so H[2, 2] == 1.

    The closed-form adjugate: the determinant cancels in the
    normalization, and thousands of tiny matrices need no LAPACK call (on
    a card ``torch.linalg.inv`` synchronizes with the host).
    """
    (a, b, c), (d, e, f), (g, h, i) = (r.unbind(dim=-1)
                                       for r in hmat.unbind(dim=-2))
    adj = _matrix([[e * i - f * h, c * h - b * i, b * f - c * e],
                   [f * g - d * i, a * i - c * g, c * d - a * f],
                   [d * h - e * g, b * g - a * h, a * e - b * d]])
    return adj / adj[..., 2:, 2:]


def compose_theta(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose 3x3 homographies: (a ∘ b)(p) = a(b(p))."""
    m = a @ b
    return m / m[..., 2:, 2:]


def stabilizing_theta(path_window: torch.Tensor) -> torch.Tensor:
    """The warp that maps a window's LAST frame to the window-mean camera
    position, A_t⁻¹ ∘ Ā, for path windows (..., n, 5).

    Within a short window the still's absolute position is unobservable,
    so the learnable stabilization target is the local mean of the camera
    path — what a stabilizer's path smoothing does.
    """
    mean_params = path_window.mean(dim=-2)
    a_t_inv = invert_theta(jitter_theta(path_window[..., -1, :]))
    return compose_theta(a_t_inv, jitter_theta(mean_params))


def theta_to_offsets(hmat: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """Coarse control-grid offsets (..., gh, gw, 2) sampling homographies
    at the grid points. Affine parts are reproduced exactly by bilinear
    upsampling; mild projective terms with O(cell²) error."""
    return (grid_ops.homography_grid(hmat, gh, gw)
            - grid_ops.identity_grid(gh, gw, hmat.device))


def jitter_frames(still: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Render shaky frames (T, H, W, C): the still (H, W, C) sampled
    through each pose of ``params`` (T, 5)."""
    h, w, _ = still.shape
    if len(params) == 0:
        return still.new_zeros((0, *still.shape))
    grids = grid_ops.homography_grid(jitter_theta(params), h, w)
    return torch.cat([
        warp_ops.warp_batch(
            still[None].expand(len(g), -1, -1, -1).contiguous(), g)
        for g in grids.split(_RENDER_CHUNK)])


def jitter_frame(still: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Render one shaky frame: sample the still through the jitter warp."""
    return jitter_frames(still, params[None])[0]


def synthetic_clip(generator: torch.Generator, num_frames: int, height: int,
                   width: int, device=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A shaky clip with ground truth.

    Returns:
      frames: (T, H, W, 3) f32 in [0,1] — the unstable clip.
      still:  (H, W, 3) f32 — the stable ground-truth image.
      path:   (T, 5) per-frame jitter (tx, ty, angle, px, py).
    """
    still = random_still(generator, height, width, device=device)
    path = random_camera_path(generator, num_frames, device=device)
    return jitter_frames(still, path), still, path


def to_u8(x: torch.Tensor) -> torch.Tensor:
    """f32 [0, 1] → uint8, round half to even."""
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)


def synthetic_clip_u8(generator: torch.Generator, num_frames: int,
                      height: int, width: int, device=None):
    """uint8 variant; returns (frames_u8, still_u8, path)."""
    frames, still, path = synthetic_clip(generator, num_frames, height,
                                         width, device=device)
    return to_u8(frames), to_u8(still), path
