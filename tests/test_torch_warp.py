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


@pytest.mark.parametrize("shape,packed", [
    ((16, 720, 1280, 3), True),        # the stabilize path's chunk
    ((16, 1080, 1920, 3), True),
    ((2, 40, 152, 3), True),
    ((16, 480, 854, 3), False),        # 854 * 3 is no multiple of 4
    ((3, 97, 131, 3), False),
    ((2, 40, 150, 3), False),          # W * C % 4 == 0 but W % 4 != 0
    ((2, 40, 152, 1), False),          # the packed kernel is RGB only
    ((2, 40, 152, 4), False),
    ((1, 32768, 32768, 3), False),     # a frame over 2^31 bytes
    ((1, 65536, 8, 3), False),         # launch dimensions the device refuses
    ((65536, 8, 8, 3), False),
])
def test_kernel_choice_is_by_shape_alone(shape, packed):
    """The wrapper's pick between the packed and the general-shape CUDA
    kernel is a function of the frames' shape."""
    assert twarp_wide.takes_packed_kernel(shape) is packed
    assert twarp_wide.takes_packed_kernel(torch.Size(shape)) is packed


@pytest.mark.parametrize("shape", [(2, 40, 152, 3), (2, 40, 150, 3),
                                   (1, 24, 64, 1), (1, 24, 64, 4)])
def test_plain_within_1lsb_of_reference_oracle_on_both_kernels_shapes(shape):
    """Shapes of the packed and of the general kernel alike run the plain
    version on the CPU, within 1 LSB of the reference oracle on the
    reference's grid."""
    b, h, w, c = shape
    frames, offs = _inputs(9, b=b, h=h, w=w, c=c, amp=0.3)
    grids = np.stack([np.asarray(jgrid.grid_from_offsets(
        jnp.asarray(o), h, w, border_crop=0.05)) for o in offs])
    ref = np.asarray(jwarp_ref.warp_quantize_oracle(jnp.asarray(frames),
                                                    jnp.asarray(grids)))
    ours = twarp_wide.warp_u8_offsets(torch.from_numpy(frames),
                                      torch.from_numpy(offs), 0.05).numpy()
    assert ours.shape == frames.shape
    assert np.abs(ours.astype(int) - ref).max() <= 1


@pytest.mark.parametrize("frames_shape,out_hw,packed", [
    ((16, 720, 1280, 3), (720, 1280), True),     # the 720p chunk
    ((16, 1080, 1920, 3), (1080, 1920), True),   # the 1080p chunk
    ((2, 40, 152, 3), (36, 100), True),          # output size != input's
    ((2, 8, 4, 3), (3, 4), True),                # one pixel group a row
    ((1, 65536, 8, 3), (8, 8), True),            # no launch axis follows H
    ((2, 40, 150, 3), (40, 152), False),         # W % 4 != 0
    ((2, 40, 152, 3), (36, 102), False),         # Wo % 4 != 0
    ((16, 480, 854, 3), (480, 854), False),
    ((2, 40, 152, 1), (40, 152), False),         # the packed kernel is RGB
    ((2, 40, 152, 4), (40, 152), False),
    ((1, 32768, 32768, 3), (8, 8), False),       # a frame over 2^31 bytes
    ((1, 8, 8, 3), (32768, 32768), False),       # an output frame over it
    ((65536, 8, 8, 3), (8, 8), False),           # launch axes the device
    ((1, 8, 8, 3), (65536, 8), False),           # refuses
])
def test_batch_kernel_choice_is_by_shape_alone(frames_shape, out_hw, packed):
    """The dense-grid wrapper's pick between the packed and the
    general-shape CUDA kernel is a function of the two shapes."""
    grids_shape = (frames_shape[0], *out_hw, 2)
    assert twarp_wide.takes_packed_batch_kernel(frames_shape,
                                                grids_shape) is packed
    assert twarp_wide.takes_packed_batch_kernel(
        torch.Size(frames_shape), torch.Size(grids_shape)) is packed


def _u8_kernel_rule(frames, grids, pair_start_clamp):
    """The uint8 kernels' arithmetic in torch: 0..255 taps, the coordinate
    in the kernels' f32 order, one round half to even. With
    ``pair_start_clamp`` the packed kernel's rule (the tap pair starts at
    min(floor(x), W - 2), so x = W - 1 puts weight 1.0 on the second tap),
    else the general kernel's and the oracle's (x1 = min(x0 + 1, W - 1))."""
    b, h, w, c = frames.shape
    src = frames.to(torch.float32).reshape(b, h * w, c)
    x = torch.clamp((grids[..., 0] + 1.0) * 0.5 * (w - 1), 0.0, w - 1)
    y = torch.clamp((grids[..., 1] + 1.0) * 0.5 * (h - 1), 0.0, h - 1)
    x0 = torch.floor(x)
    if pair_start_clamp:
        x0 = torch.clamp(x0, max=w - 2)
        x1 = x0 + 1
    else:
        x1 = torch.clamp(x0 + 1, max=w - 1)
    fx, y0 = (x - x0)[..., None], torch.floor(y)
    fy, y1 = (y - y0)[..., None], torch.clamp(y0 + 1, max=h - 1)

    def tap(yi, xi):
        idx = (yi.long() * w + xi.long()).reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(src, 1, idx).reshape(*xi.shape, c)

    v00, v01, v10, v11 = tap(y0, x0), tap(y0, x1), tap(y1, x0), tap(y1, x1)
    top = v00 + (v01 - v00) * fx
    bot = v10 + (v11 - v10) * fx
    acc = top + (bot - top) * fy
    return torch.clamp(torch.round(acc), 0, 255).to(torch.uint8), x, y


@pytest.mark.parametrize("shape,out_hw", [((2, 24, 32, 3), (20, 28)),
                                          ((2, 40, 152, 3), (36, 100)),
                                          ((1, 5, 4, 3), (6, 8))])
def test_packed_pair_start_rule_gives_the_general_bytes(shape, out_hw):
    """Starting the tap pair at W - 2 with weight 1.0 on its second tap
    gives the bytes of the oracle's clamped second tap, on grids that leave
    the frame on every side; both rules within 1 LSB of the oracle."""
    rng = np.random.default_rng(10)
    b, h, w, _ = shape
    frames = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
    grids = torch.from_numpy(
        rng.uniform(-2.0, 2.0, (b, *out_hw, 2)).astype(np.float32))
    packed, x, y = _u8_kernel_rule(frames, grids, True)
    general, _, _ = _u8_kernel_rule(frames, grids, False)
    # The clamps were reached on every side.
    assert bool((x == w - 1).any() and (x == 0).any()
                and (y == h - 1).any() and (y == 0).any())
    assert torch.equal(packed, general)
    oracle = twarp_ref.warp_quantize_oracle(frames, grids)
    assert int((packed.int() - oracle.int()).abs().max()) <= 1


@pytest.mark.parametrize("shape,out_hw", [((2, 40, 152, 3), (36, 100)),
                                          ((2, 37, 150, 3), (23, 61)),
                                          ((1, 24, 64, 4), (20, 44))])
def test_warp_u8_batch_plain_within_1lsb_of_reference_oracle(shape, out_hw):
    """The packed kernel's shapes and the general kernel's alike run the
    plain dense-grid version on the CPU, within 1 LSB of the reference's
    dense-grid oracle, with an output size of its own."""
    rng = np.random.default_rng(11)
    b, h, w, c = shape
    frames = rng.integers(0, 256, shape, dtype=np.uint8)
    grids = rng.uniform(-1.3, 1.3, (b, *out_hw, 2)).astype(np.float32)
    ref = np.asarray(jwarp_wide._oracle_u8(jnp.asarray(frames),
                                           jnp.asarray(grids)))
    ours = twarp_wide.warp_u8_batch(torch.from_numpy(frames),
                                    torch.from_numpy(grids)).numpy()
    assert ours.shape == (b, *out_hw, c) and ours.dtype == np.uint8
    assert np.abs(ours.astype(int) - ref).max() <= 1
