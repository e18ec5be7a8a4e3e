"""f32 bilinear warp through a dense grid, and its grid-differentiable form:
the training path's two warps.

The counterpart of the reference's ``dvsg_tpu/ops/warp_pallas.py``:

* ``bilinear_warp_batch`` — frames (B, H, W, C) × grids (B, Ho, Wo, 2) →
  (B, Ho, Wo, C), ``grid_sample(bilinear, border, align_corners=True)``.
  Renders the training batch (no gradient).
* ``bilinear_warp_batch_grids_diff`` — the same values, differentiable with
  respect to the GRIDS only: the pixel loss differentiates through the
  sampling grid into the CNN while the sampled frames are data. The forward
  also emits the per-channel derivative images ∂out/∂x, ∂out/∂y (pixel
  units) from the same four taps; the backward contracts the output
  cotangent with them, masks coordinates the border clamp held
  (strict interior ``0 < coord < S - 1`` on the unclamped coordinate) and
  rescales to normalized units. The frames' gradient is ``None``.

On CUDA tensors every function launches its hand-written kernel from
``csrc/warp_bilinear.cu`` (or raises); on CPU tensors it runs the plain
PyTorch version beside it. The CUDA kernels read any in-range address, so
the reference's displacement bound, tile height, coverage guard and
interpret switch have no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from dvsg_tpu_torch.ops import warp_ref

# Kernel launches made in this process, one count per kernel (a run reads
# them before and after to show its path went through the kernels).
LAUNCHES_WARP = 0         # bilinear_warp_batch
LAUNCHES_DIFF_FWD = 0     # forward of bilinear_warp_batch_grids_diff
LAUNCHES_DIFF_BWD = 0     # its backward


def _check(frames: torch.Tensor, grids: torch.Tensor) -> None:
    if frames.dim() != 4 or not frames.is_floating_point():
        raise ValueError(f"frames must be floating (B, H, W, C), got "
                         f"{frames.dtype} {tuple(frames.shape)}")
    if (grids.dim() != 4 or grids.shape[-1] != 2
            or grids.shape[0] != frames.shape[0]):
        raise ValueError(f"grids must be (B, Ho, Wo, 2) with B = "
                         f"{frames.shape[0]}, got {tuple(grids.shape)}")
    if frames.device != grids.device:
        raise ValueError(f"frames on {frames.device} but grids on "
                         f"{grids.device}")


# --- plain versions ----------------------------------------------------------

def bilinear_warp_batch_plain(frames: torch.Tensor, grids: torch.Tensor
                              ) -> torch.Tensor:
    """The plain PyTorch version of the warp kernel (any device)."""
    _check(frames, grids)
    return warp_ref.bilinear_warp_batch(frames, grids)


def warp_diff_forward_plain(frames: torch.Tensor, grids: torch.Tensor):
    """Plain version of the differentiable forward: (out, dximg, dyimg),
    each (B, Ho, Wo, C) f32 (f64 for f64 frames)."""
    (v00, v01, v10, v11), (fx, fy) = warp_ref.bilinear_taps(frames, grids)
    top = v00 + (v01 - v00) * fx
    bot = v10 + (v11 - v10) * fx
    out = top + (bot - top) * fy
    dximg = (1.0 - fy) * (v01 - v00) + fy * (v11 - v10)
    dyimg = (1.0 - fx) * (v10 - v00) + fx * (v11 - v01)
    return out, dximg, dyimg


def warp_diff_backward_plain(g: torch.Tensor, dximg: torch.Tensor,
                             dyimg: torch.Tensor, grids: torch.Tensor,
                             h: int, w: int) -> torch.Tensor:
    """Plain version of the backward: the grid cotangent (B, Ho, Wo, 2)
    for the output cotangent ``g`` and an (h, w) source frame."""
    g = g.to(dximg.dtype)
    gr = grids.to(dximg.dtype)
    x = (gr[..., 0] + 1.0) * 0.5 * (w - 1)
    y = (gr[..., 1] + 1.0) * 0.5 * (h - 1)
    # Clamp subgradient: zero where the unclamped coordinate was held.
    mask_x = ((x > 0.0) & (x < w - 1)).to(g.dtype)
    mask_y = ((y > 0.0) & (y < h - 1)).to(g.dtype)
    dgx = (g * dximg).sum(dim=-1) * mask_x * (0.5 * (w - 1))
    dgy = (g * dyimg).sum(dim=-1) * mask_y * (0.5 * (h - 1))
    return torch.stack([dgx, dgy], dim=-1)


# --- kernels -------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _kernels():
    """The C launchers of csrc/warp_bilinear.cu (built at first use)."""
    from dvsg_tpu_torch.ops import _build
    lib = _build.library("warp_bilinear")
    fns = {}
    for name, n_ptr in (("dvsg_warp_f32", 3), ("dvsg_warp_f32_diff_fwd", 5),
                        ("dvsg_warp_f32_diff_bwd", 5)):
        fn = getattr(lib, name)
        fn.argtypes = [_P] * n_ptr + [_I] * 6 + [_P]
        fn.restype = _I
        fns[name] = fn
    return fns


def _run(name: str, tensors, dims, device) -> None:
    """Launch one kernel on the current stream of ``device``; raise if the
    device refused the launch."""
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = _kernels()[name](*(t.data_ptr() for t in tensors), *dims,
                              stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _dims(frames: torch.Tensor, grids: torch.Tensor):
    b, h, w, c = frames.shape
    return b, h, w, c, grids.shape[1], grids.shape[2]


def _as_f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _launch_warp(frames: torch.Tensor, grids: torch.Tensor) -> torch.Tensor:
    """The warp kernel on contiguous f32 CUDA tensors."""
    global LAUNCHES_WARP
    b, _, _, c, ho, wo = dims = _dims(frames, grids)
    out = torch.empty((b, ho, wo, c), dtype=torch.float32,
                      device=frames.device)
    if out.numel():
        _run("dvsg_warp_f32", (frames, grids, out), dims, frames.device)
        LAUNCHES_WARP += 1
    return out


def _launch_diff_fwd(frames: torch.Tensor, grids: torch.Tensor):
    global LAUNCHES_DIFF_FWD
    b, _, _, c, ho, wo = dims = _dims(frames, grids)
    out, dximg, dyimg = (torch.empty((b, ho, wo, c), dtype=torch.float32,
                                     device=frames.device)
                         for _ in range(3))
    if out.numel():
        _run("dvsg_warp_f32_diff_fwd", (frames, grids, out, dximg, dyimg),
             dims, frames.device)
        LAUNCHES_DIFF_FWD += 1
    return out, dximg, dyimg


def _launch_diff_bwd(g: torch.Tensor, dximg: torch.Tensor,
                     dyimg: torch.Tensor, grids: torch.Tensor,
                     h: int, w: int) -> torch.Tensor:
    global LAUNCHES_DIFF_BWD
    b, ho, wo, c = dximg.shape
    dgrids = torch.empty((b, ho, wo, 2), dtype=torch.float32,
                         device=g.device)
    if dgrids.numel():
        _run("dvsg_warp_f32_diff_bwd", (g, dximg, dyimg, grids, dgrids),
             (b, h, w, c, ho, wo), g.device)
        LAUNCHES_DIFF_BWD += 1
    return dgrids


# --- public functions ----------------------------------------------------------

def bilinear_warp_batch(frames: torch.Tensor, grids: torch.Tensor
                        ) -> torch.Tensor:
    """frames (B, H, W, C) × grids (B, Ho, Wo, 2) → (B, Ho, Wo, C) in
    frames.dtype; interpolation in f32. No gradient flows through it.

    CUDA tensors go through the CUDA kernel (or raise); CPU tensors through
    the plain version.
    """
    _check(frames, grids)
    if not frames.is_cuda:
        return bilinear_warp_batch_plain(frames.detach(), grids.detach())
    out = _launch_warp(_as_f32(frames.detach()), _as_f32(grids.detach()))
    return out.to(frames.dtype)


def warp_diff_forward(frames: torch.Tensor, grids: torch.Tensor):
    """(out, dximg, dyimg) of the differentiable warp's forward, f32: the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    _check(frames, grids)
    if not frames.is_cuda:
        return warp_diff_forward_plain(frames, grids)
    return _launch_diff_fwd(_as_f32(frames), _as_f32(grids))


def warp_diff_backward(g: torch.Tensor, dximg: torch.Tensor,
                       dyimg: torch.Tensor, grids: torch.Tensor,
                       h: int, w: int) -> torch.Tensor:
    """The grid cotangent (B, Ho, Wo, 2) f32 from the output cotangent and
    the forward's derivative images."""
    if (g.shape != dximg.shape or dyimg.shape != dximg.shape
            or grids.shape != (*dximg.shape[:3], 2)):
        raise ValueError(
            f"cotangent {tuple(g.shape)}, derivative images "
            f"{tuple(dximg.shape)} / {tuple(dyimg.shape)} and grids "
            f"{tuple(grids.shape)} do not belong to one warp")
    if not g.is_cuda:
        return warp_diff_backward_plain(g, dximg, dyimg, grids, h, w)
    return _launch_diff_bwd(_as_f32(g), _as_f32(dximg), _as_f32(dyimg),
                            _as_f32(grids), h, w)


class _WarpGridsDiff(torch.autograd.Function):
    """out = warp(frames, grids) with d(out)/d(grids) only; ``plain``
    selects the plain halves whatever the device."""

    @staticmethod
    def forward(ctx, frames, grids, plain):
        fwd = warp_diff_forward_plain if plain else warp_diff_forward
        out, dximg, dyimg = fwd(frames, grids)
        ctx.save_for_backward(dximg, dyimg, grids)
        ctx.src_hw = (frames.shape[1], frames.shape[2])
        ctx.plain = plain
        return out.to(frames.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        dximg, dyimg, grids = ctx.saved_tensors
        bwd = warp_diff_backward_plain if ctx.plain else warp_diff_backward
        dgrids = bwd(g, dximg, dyimg, grids, *ctx.src_hw)
        return None, dgrids.to(grids.dtype), None


def bilinear_warp_batch_grids_diff_plain(frames: torch.Tensor,
                                         grids: torch.Tensor
                                         ) -> torch.Tensor:
    """The plain PyTorch version of the differentiable warp (any device):
    the same derivative images, mask and missing frame gradient as the
    kernels, not autograd through the four-tap gather."""
    _check(frames, grids)
    return _WarpGridsDiff.apply(frames, grids, True)


def bilinear_warp_batch_grids_diff(frames: torch.Tensor, grids: torch.Tensor
                                   ) -> torch.Tensor:
    """The warp of ``bilinear_warp_batch``, differentiable with respect to
    ``grids`` only (the frames' gradient is None).

    With no gradient to record it is the plain warp (no derivative images
    are made).
    """
    _check(frames, grids)
    if not (torch.is_grad_enabled() and grids.requires_grad):
        return bilinear_warp_batch(frames, grids)
    return _WarpGridsDiff.apply(frames, grids, False)
