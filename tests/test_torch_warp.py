"""The port's warp ops against the JAX package on the CPU.

On a CPU tensor ``warp_u8_offsets`` runs its plain version (the CUDA
kernel is held against that same plain version on the card, see
tests/test_torch_cuda.py and chip_smoke.py). Here the plain version is
held within 1 LSB of the reference Pallas kernel (interpret mode), and the
oracle byte-equal to the reference oracle on the same grid.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvsg_tpu.ops import grid as jgrid
from dvsg_tpu.ops import warp_ref as jwarp_ref
from dvsg_tpu.ops import warp_wide as jwarp_wide
from dvsg_tpu_torch.ops import grid as tgrid
from dvsg_tpu_torch.ops import warp as twarp
from dvsg_tpu_torch.ops import warp_ref as twarp_ref
from dvsg_tpu_torch.ops import warp_wide as twarp_wide


def _inputs(seed, b=2, h=40, w=150, gh=6, gw=8, amp=0.2, c=3):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (b, h, w, c), dtype=np.uint8)
    offs = rng.uniform(-amp, amp, (b, gh, gw, 2)).astype(np.float32)
    return frames, offs


@pytest.mark.parametrize("crop", [0.0, 0.1])
def test_plain_within_1lsb_of_reference_kernel(crop):
    frames, offs = _inputs(0)
    ref = np.asarray(jwarp_wide.warp_u8_offsets(
        jnp.asarray(frames), jnp.asarray(offs), border_crop=crop,
        interpret=True))
    ours = twarp_wide.warp_u8_offsets(torch.from_numpy(frames),
                                      torch.from_numpy(offs), crop).numpy()
    assert ours.dtype == np.uint8 and ours.shape == frames.shape
    assert np.abs(ours.astype(int) - ref).max() <= 1


@pytest.mark.parametrize("amp,crop", [(0.2, 0.0), (0.2, 0.1), (1.5, 0.0)])
def test_oracle_byte_equal_to_reference_oracle(amp, crop):
    frames, offs = _inputs(1, amp=amp)
    h, w = frames.shape[1:3]
    grids = np.stack([np.asarray(jgrid.grid_from_offsets(
        jnp.asarray(o), h, w, border_crop=crop)) for o in offs])
    ref = np.asarray(jwarp_ref.warp_quantize_oracle(jnp.asarray(frames),
                                                    jnp.asarray(grids)))
    ours = twarp_ref.warp_quantize_oracle(torch.from_numpy(frames),
                                          torch.from_numpy(grids)).numpy()
    np.testing.assert_array_equal(ours, ref)
    # The CPU warp_u8_offsets builds its own grid: within 1 LSB of it.
    plain = twarp_wide.warp_u8_offsets(torch.from_numpy(frames),
                                       torch.from_numpy(offs), crop).numpy()
    assert np.abs(plain.astype(int) - ref).max() <= 1


def test_bilinear_warp_matches_reference():
    rng = np.random.default_rng(2)
    frame = rng.random((20, 30, 3), dtype=np.float32)
    grid = rng.uniform(-1.3, 1.3, (11, 17, 2)).astype(np.float32)
    ref = np.asarray(jwarp_ref.bilinear_warp(jnp.asarray(frame),
                                             jnp.asarray(grid)))
    ours = twarp_ref.bilinear_warp(torch.from_numpy(frame),
                                   torch.from_numpy(grid)).numpy()
    np.testing.assert_array_equal(ours, ref)


def test_bilinear_warp_equals_grid_sample():
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(rng.random((2, 20, 30, 3), dtype=np.float32))
    grids = torch.from_numpy(
        rng.uniform(-1.2, 1.2, (2, 9, 13, 2)).astype(np.float32))
    ours = twarp_ref.bilinear_warp_batch(frames, grids)
    lib = torch.nn.functional.grid_sample(
        frames.permute(0, 3, 1, 2), grids, mode="bilinear",
        padding_mode="border", align_corners=True).permute(0, 2, 3, 1)
    torch.testing.assert_close(ours, lib, rtol=0, atol=1e-5)


def test_zero_offsets_are_identity():
    frames, offs = _inputs(4)
    out = twarp_wide.warp_u8_offsets(torch.from_numpy(frames),
                                     torch.zeros_like(torch.from_numpy(offs)))
    np.testing.assert_array_equal(out.numpy(), frames)


@pytest.mark.parametrize("crop", [-0.1, 0.5, 0.7])
def test_border_crop_outside_range_raises(crop):
    frames, offs = _inputs(5)
    with pytest.raises(ValueError, match="border_crop"):
        twarp_wide.warp_u8_offsets(torch.from_numpy(frames),
                                   torch.from_numpy(offs), crop)


@pytest.mark.parametrize("bad", ["dtype", "batch", "rank", "last"])
def test_bad_inputs_raise(bad):
    frames, offs = _inputs(6)
    f, o = torch.from_numpy(frames), torch.from_numpy(offs)
    if bad == "dtype":
        f = f.float()
    elif bad == "batch":
        o = o[:1]
    elif bad == "rank":
        f = f[0]
    else:
        o = o[..., :1]
    with pytest.raises(ValueError):
        twarp_wide.warp_u8_offsets(f, o)


def test_warp_quantize_batch_offsets_path_and_dense_grids():
    frames, offs = _inputs(7)
    f, o = torch.from_numpy(frames), torch.from_numpy(offs)
    out = twarp.warp_quantize_batch(f, offsets=o, border_crop=0.05)
    torch.testing.assert_close(out, twarp_wide.warp_u8_offsets(f, o, 0.05),
                               rtol=0, atol=0)
    grids = tgrid.grid_from_offsets(o, 40, 150)
    # Dense grids go to the dense-grid op: the oracle on the CPU, and the
    # same warp as the offsets path when the grid is built from them.
    dense = twarp.warp_quantize_batch(f, grids=grids)
    torch.testing.assert_close(dense, twarp_wide.warp_u8_batch(f, grids),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        dense, twarp.warp_quantize_batch(f, offsets=o), rtol=0, atol=0)
    with pytest.raises(ValueError):
        twarp.warp_quantize_batch(f)


def test_offset_rows_is_the_vertical_upsample():
    """The kernel's wrapper input: (B, H, gw, 2) rows whose horizontal
    upsample gives the reference's dense offsets."""
    _, offs = _inputs(8)
    o = torch.from_numpy(offs)
    rows = twarp_wide.offset_rows(o, 40)
    assert rows.shape == (2, 40, 8, 2) and rows.is_contiguous()
    dense = tgrid.upsample_offsets(o, 40, 150)
    cm = torch.from_numpy(np.array(twarp_wide.resize_ops._resize_matrix(
        8, 150)))
    torch.testing.assert_close(torch.einsum("qw,bpwk->bpqk", cm, rows),
                               dense, rtol=0, atol=1e-6)
