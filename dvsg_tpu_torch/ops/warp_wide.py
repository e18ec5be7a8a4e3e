"""Fused warp + quantize on uint8 frames: from coarse offsets (the inference
hot op) and from dense grids.

``warp_u8_offsets`` takes uint8 (B, H, W, C) frames and the CNN's coarse
(B, gh, gw, 2) normalized offsets and returns the warped uint8 frames. On
a CUDA tensor it launches one of the two hand-written kernels of
``csrc/warp_u8_offsets.cu``, picked from the shape alone
(``takes_packed_kernel``): the packed kernel for RGB frames whose width is
a multiple of four, the general-shape kernel for everything else. On a CPU
tensor it runs the plain version,
``warp_quantize_oracle(frames, grid_from_offsets(offsets, H, W, crop))``.
Kernels and plain version agree within 1 LSB: the kernels compute the same
coordinates through a different order of f32 operations, and round their
0..255 accumulator where the plain version rounds (x / 255) * 255.

The offsets are upsampled in two halves: the vertical one
(``offset_rows``) is a plain matrix product, and the rest runs in the
registered op ``torch.ops.dvsg_torch.warp_u8_offsets_rows(frames, rows,
crop)``: the kernel on the card, the plain version on the CPU. Being an op
of the dispatcher, it is what ``torch.export`` records in an exported
chunk step (export.py), where a ctypes launch could not be traced.

``warp_u8_batch`` is the dense-grid form: uint8 (B, H, W, C) frames and
(B, Ho, Wo, 2) normalized grids → uint8 (B, Ho, Wo, C), any output size.
On a CUDA tensor it launches one of the two kernels of
``csrc/warp_u8_batch.cu``, picked from the shapes alone
(``takes_packed_batch_kernel``): the packed kernel for RGB frames whose
input and output widths are multiples of four, the general-shape kernel
otherwise. The two give the same bytes. On a CPU tensor it runs
``warp_quantize_oracle``, within 1 LSB of the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dvsg_tpu_torch.ops import grid as grid_ops
from dvsg_tpu_torch.ops import resize as resize_ops
from dvsg_tpu_torch.ops import warp_ref
from dvsg_tpu_torch.ops.grouped import CHUNK_GROUP, in_groups

# Kernel launches made by warp_u8_offsets in this process (a run reads it
# before and after to show its main path went through the kernel), and
# those of them that were the packed kernel.
LAUNCHES = 0
LAUNCHES_PACKED = 0
# Kernel launches made by warp_u8_batch, and those of them that were the
# packed kernel.
LAUNCHES_BATCH = 0
LAUNCHES_BATCH_PACKED = 0


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
    return warp_u8_rows_plain(frames_u8,
                              offset_rows(offsets, frames_u8.shape[1]),
                              border_crop)


def warp_u8_rows_plain(frames_u8: torch.Tensor, rows: torch.Tensor,
                       border_crop: float) -> torch.Tensor:
    """The plain version from the offset rows (B, H, gw, 2): the horizontal
    half of the upsample, the identity grid zoomed by the crop, the warp:
    ``grid_from_offsets``'s arithmetic, step for step."""
    h, w = frames_u8.shape[1], frames_u8.shape[2]
    cm = resize_ops._matrix(rows.shape[2], w, rows)
    dense = torch.einsum("qw,...pwc->...pqc", cm, rows)
    grids = (grid_ops.identity_grid(h, w, rows.device)
             * (1.0 - 2.0 * border_crop) + dense)
    return warp_ref.warp_quantize_oracle(frames_u8, grids)


def offset_rows(offsets: torch.Tensor, h: int) -> torch.Tensor:
    """(B, gh, gw, 2) → (B, H, gw, 2): the vertical half of the offset
    upsample, one small matrix product (on the card in calls of a fixed
    frame count, so a frame's rows do not depend on B: ops/grouped.py), as
    the reference does it outside its kernel."""
    r = resize_ops._matrix(offsets.shape[1], h, offsets)
    return in_groups(lambda o: torch.einsum("ph,bhwk->bpwk", r, o),
                     offsets.to(torch.float32), CHUNK_GROUP).contiguous()


def takes_packed_kernel(shape) -> bool:
    """Whether (B, H, W, C) frames go to the packed kernel: RGB, rows of
    whole four-pixel groups, in-frame byte offsets that fit 32 bits, and a
    (W tiles, H, B) launch the device accepts. Every other shape goes to
    the general-shape kernel."""
    b, h, w, c = shape
    return (c == 3 and w % 4 == 0 and h * w * c < 2 ** 31
            and b <= 65535 and h <= 65535)


@functools.cache
def _kernels():
    """The C launchers of csrc/warp_u8_offsets.cu (built at first use):
    (general, packed)."""
    from dvsg_tpu_torch.ops import _build
    lib = _build.library("warp_u8_offsets")
    fns = lib.dvsg_warp_u8_offsets, lib.dvsg_warp_u8_offsets_packed
    for fn in fns:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


def _launch(frames_u8: torch.Tensor, rows: torch.Tensor,
            border_crop: float, packed: bool | None = None) -> torch.Tensor:
    """One kernel launch on contiguous CUDA frames and their offset rows;
    ``packed`` overrides the choice by shape (timing the two side by side)."""
    global LAUNCHES, LAUNCHES_PACKED
    if packed is None:
        packed = takes_packed_kernel(frames_u8.shape)
    b, h, w, c = frames_u8.shape
    out = torch.empty_like(frames_u8)
    if out.numel() == 0:
        return out
    if packed and frames_u8.data_ptr() % 4:
        frames_u8 = frames_u8.clone()      # a view off the word boundary
    fn = _kernels()[packed]
    stream = torch.cuda.current_stream(frames_u8.device).cuda_stream
    with torch.cuda.device(frames_u8.device):
        rc = fn(frames_u8.data_ptr(), rows.data_ptr(), out.data_ptr(),
                b, h, w, c, rows.shape[2], float(border_crop), stream)
    if rc != 0:
        raise RuntimeError(f"warp_u8_offsets kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    LAUNCHES_PACKED += packed
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
    return warp_u8_offsets_rows(frames_u8,
                                offset_rows(offsets, frames_u8.shape[1]),
                                float(border_crop))


@torch.library.custom_op("dvsg_torch::warp_u8_offsets_rows", mutates_args=(),
                         device_types="cpu")
def warp_u8_offsets_rows(frames_u8: torch.Tensor, rows: torch.Tensor,
                         border_crop: float) -> torch.Tensor:
    """uint8 (B, H, W, C) frames × their (B, H, gw, 2) offset rows →
    (B, H, W, C) uint8: the offsets kernel as an op of the dispatcher. On
    the CPU it is the plain version."""
    return warp_u8_rows_plain(frames_u8, rows, border_crop)


@warp_u8_offsets_rows.register_kernel("cuda")
def _warp_u8_offsets_rows_cuda(frames_u8: torch.Tensor, rows: torch.Tensor,
                               border_crop: float) -> torch.Tensor:
    return _launch(frames_u8.contiguous(), rows.contiguous(), border_crop)


@warp_u8_offsets_rows.register_fake
def _warp_u8_offsets_rows_fake(frames_u8: torch.Tensor, rows: torch.Tensor,
                               border_crop: float) -> torch.Tensor:
    return frames_u8.new_empty(frames_u8.shape)


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


def takes_packed_batch_kernel(frames_shape, grids_shape) -> bool:
    """Whether (B, H, W, C) frames warped through (B, Ho, Wo, 2) grids go
    to the packed dense-grid kernel: RGB, input and output rows of whole
    four-pixel groups, input and output frames whose byte offsets fit 32
    bits, and a (Wo tiles, Ho, B) launch the device accepts. Every other
    shape goes to the general-shape kernel."""
    b, h, w, c = frames_shape
    ho, wo = grids_shape[1], grids_shape[2]
    return (c == 3 and w % 4 == 0 and wo % 4 == 0 and h * w * c < 2 ** 31
            and ho * wo * c < 2 ** 31 and b <= 65535 and ho <= 65535)


@functools.cache
def _batch_kernels():
    """The C launchers of csrc/warp_u8_batch.cu (built at first use):
    (general, packed)."""
    from dvsg_tpu_torch.ops import _build
    lib = _build.library("warp_u8_batch")
    fns = lib.dvsg_warp_u8_batch, lib.dvsg_warp_u8_batch_packed
    for fn in fns:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


def _launch_batch(frames_u8: torch.Tensor, grids: torch.Tensor,
                  packed: bool | None = None) -> torch.Tensor:
    """One dense-grid kernel launch on contiguous CUDA tensors (f32 grids);
    ``packed`` overrides the choice by shape (timing the two side by
    side)."""
    global LAUNCHES_BATCH, LAUNCHES_BATCH_PACKED
    if packed is None:
        packed = takes_packed_batch_kernel(frames_u8.shape, grids.shape)
    b, h, w, c = frames_u8.shape
    ho, wo = grids.shape[1], grids.shape[2]
    out = torch.empty((b, ho, wo, c), dtype=torch.uint8,
                      device=frames_u8.device)
    if out.numel() == 0:
        return out
    if packed and frames_u8.data_ptr() % 4:
        frames_u8 = frames_u8.clone()      # a view off the word boundary
    if packed and grids.data_ptr() % 16:
        grids = grids.clone()              # a view off the 16-byte boundary
    fn = _batch_kernels()[packed]
    stream = torch.cuda.current_stream(frames_u8.device).cuda_stream
    with torch.cuda.device(frames_u8.device):
        rc = fn(frames_u8.data_ptr(), grids.data_ptr(), out.data_ptr(),
                b, h, w, c, ho, wo, stream)
    if rc != 0:
        raise RuntimeError(f"warp_u8_batch kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES_BATCH += 1
    LAUNCHES_BATCH_PACKED += packed
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
