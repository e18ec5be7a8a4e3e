"""Fused warp + quantize on uint8 frames: from coarse offsets (the inference
hot op) and from dense grids.

``warp_u8_offsets`` takes uint8 (B, H, W, C) frames and the CNN's coarse
(B, gh, gw, 2) normalized offsets and returns the warped uint8 frames. On
a CUDA tensor it launches the hand-written kernel
``csrc/warp_u8_offsets.cu``; on a CPU tensor it runs the plain version,
``warp_quantize_oracle(frames, grid_from_offsets(offsets, H, W, crop))``.
The two agree within 1 LSB: the kernel computes the same coordinates
through a different order of f32 operations, and rounds its 0..255
accumulator where the plain version rounds (x / 255) * 255.

``warp_u8_batch`` is the dense-grid form: uint8 (B, H, W, C) frames and
(B, Ho, Wo, 2) normalized grids → uint8 (B, Ho, Wo, C), any output size;
``csrc/warp_u8_batch.cu`` on a CUDA tensor, ``warp_quantize_oracle`` on a
CPU tensor, the same 1 LSB apart.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dvsg_tpu_torch.ops import grid as grid_ops
from dvsg_tpu_torch.ops import resize as resize_ops
from dvsg_tpu_torch.ops import warp_ref

# Kernel launches made by warp_u8_offsets in this process (a run reads it
# before and after to show its main path went through the kernel).
LAUNCHES = 0
# Kernel launches made by warp_u8_batch.
LAUNCHES_BATCH = 0


def _check(frames_u8: torch.Tensor, offsets: torch.Tensor,
           border_crop: float) -> None:
    if frames_u8.dtype != torch.uint8 or frames_u8.dim() != 4:
        raise ValueError(f"frames must be uint8 (B, H, W, C), got "
                         f"{frames_u8.dtype} {tuple(frames_u8.shape)}")
    if (offsets.dim() != 4 or offsets.shape[-1] != 2
            or offsets.shape[0] != frames_u8.shape[0]):
        raise ValueError(f"offsets must be (B, gh, gw, 2) with B = "
                         f"{frames_u8.shape[0]}, got {tuple(offsets.shape)}")
    if not 0.0 <= border_crop < 0.5:
        # crop >= 0.5 flips the identity scale's sign.
        raise ValueError(
            f"border_crop must be in [0, 0.5), got {border_crop}")
    if frames_u8.device != offsets.device:
        raise ValueError(f"frames on {frames_u8.device} but offsets on "
                         f"{offsets.device}")


def warp_u8_offsets_plain(frames_u8: torch.Tensor, offsets: torch.Tensor,
                          border_crop: float = 0.0) -> torch.Tensor:
    """The plain PyTorch version of the kernel (any device)."""
    _check(frames_u8, offsets, border_crop)
    h, w = frames_u8.shape[1], frames_u8.shape[2]
    grids = grid_ops.grid_from_offsets(offsets, h, w, border_crop)
    return warp_ref.warp_quantize_oracle(frames_u8, grids)


def offset_rows(offsets: torch.Tensor, h: int) -> torch.Tensor:
    """(B, gh, gw, 2) → (B, H, gw, 2): the vertical half of the offset
    upsample, one small matrix product, as the reference does it outside
    its kernel."""
    r = resize_ops._matrix(offsets.shape[1], h, offsets)
    return torch.einsum("ph,bhwk->bpwk", r,
                        offsets.to(torch.float32)).contiguous()


@functools.cache
def _kernel():
    """The C launcher of csrc/warp_u8_offsets.cu (built at first use)."""
    from dvsg_tpu_torch.ops import _build
    fn = _build.library("warp_u8_offsets").dvsg_warp_u8_offsets
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(frames_u8: torch.Tensor, rows: torch.Tensor,
            border_crop: float) -> torch.Tensor:
    fn = _kernel()
    b, h, w, c = frames_u8.shape
    out = torch.empty_like(frames_u8)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(frames_u8.device).cuda_stream
    with torch.cuda.device(frames_u8.device):
        rc = fn(frames_u8.data_ptr(), rows.data_ptr(), out.data_ptr(),
                b, h, w, c, rows.shape[2], float(border_crop), stream)
    if rc != 0:
        raise RuntimeError(f"warp_u8_offsets kernel launch failed: CUDA "
                           f"error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def warp_u8_offsets(frames_u8: torch.Tensor, offsets: torch.Tensor,
                    border_crop: float = 0.0) -> torch.Tensor:
    """(B, H, W, C) uint8 frames × (B, gh, gw, 2) normalized offsets →
    (B, H, W, C) uint8, within 1 LSB of
    quantize(warp(normalize(frames), grid_from_offsets(offsets))).

    CUDA tensors go through the CUDA kernel (or raise); CPU tensors through
    the plain version.
    """
    _check(frames_u8, offsets, border_crop)
    if not frames_u8.is_cuda:
        return warp_u8_offsets_plain(frames_u8, offsets, border_crop)
    rows = offset_rows(offsets, frames_u8.shape[1])
    return _launch(frames_u8.contiguous(), rows, border_crop)


def _check_grids(frames_u8: torch.Tensor, grids: torch.Tensor) -> None:
    if frames_u8.dtype != torch.uint8 or frames_u8.dim() != 4:
        raise ValueError(f"frames must be uint8 (B, H, W, C), got "
                         f"{frames_u8.dtype} {tuple(frames_u8.shape)}")
    if (grids.dim() != 4 or grids.shape[-1] != 2
            or grids.shape[0] != frames_u8.shape[0]):
        raise ValueError(f"grids must be (B, Ho, Wo, 2) with B = "
                         f"{frames_u8.shape[0]}, got {tuple(grids.shape)}")
    if frames_u8.device != grids.device:
        raise ValueError(f"frames on {frames_u8.device} but grids on "
                         f"{grids.device}")


def warp_u8_batch_plain(frames_u8: torch.Tensor, grids: torch.Tensor
                        ) -> torch.Tensor:
    """The plain PyTorch version of the dense-grid kernel (any device)."""
    _check_grids(frames_u8, grids)
    return warp_ref.warp_quantize_oracle(frames_u8, grids)


@functools.cache
def _batch_kernel():
    """The C launcher of csrc/warp_u8_batch.cu (built at first use)."""
    from dvsg_tpu_torch.ops import _build
    fn = _build.library("warp_u8_batch").dvsg_warp_u8_batch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_batch(frames_u8: torch.Tensor, grids: torch.Tensor
                  ) -> torch.Tensor:
    """The dense-grid kernel on contiguous CUDA tensors (f32 grids)."""
    fn = _batch_kernel()
    b, h, w, c = frames_u8.shape
    ho, wo = grids.shape[1], grids.shape[2]
    out = torch.empty((b, ho, wo, c), dtype=torch.uint8,
                      device=frames_u8.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(frames_u8.device).cuda_stream
    with torch.cuda.device(frames_u8.device):
        rc = fn(frames_u8.data_ptr(), grids.data_ptr(), out.data_ptr(),
                b, h, w, c, ho, wo, stream)
    if rc != 0:
        raise RuntimeError(f"warp_u8_batch kernel launch failed: CUDA "
                           f"error {rc}")
    global LAUNCHES_BATCH
    LAUNCHES_BATCH += 1
    return out


def warp_u8_batch(frames_u8: torch.Tensor, grids: torch.Tensor
                  ) -> torch.Tensor:
    """(B, H, W, C) uint8 frames × (B, Ho, Wo, 2) normalized grids →
    (B, Ho, Wo, C) uint8, within 1 LSB of
    quantize(warp(normalize(frames), grids)).

    CUDA tensors go through the CUDA kernel (or raise); CPU tensors through
    the plain version.
    """
    _check_grids(frames_u8, grids)
    if not frames_u8.is_cuda:
        return warp_u8_batch_plain(frames_u8, grids)
    return _launch_batch(frames_u8.contiguous(),
                         grids.to(torch.float32).contiguous())
