"""The port's CUDA kernels on the card, held against their plain versions.

Marked ``cuda``: they skip on a machine without a CUDA card. On the card
they run without the JAX side of the suite (no jax is needed there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from dvsg_tpu_torch.ops import warp_wide

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape,gw,amp,crop", [
    ((2, 37, 150, 3), 8, 0.2, 0.0),
    ((2, 37, 150, 3), 8, 0.2, 0.1),
    ((3, 64, 96, 1), 16, 1.5, 0.0),
    ((1, 33, 257, 4), 5, 0.5, 0.25),
])
def test_warp_u8_offsets_kernel_matches_plain(dev, shape, gw, amp, crop):
    rng = np.random.default_rng(7)
    frames = torch.from_numpy(
        rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
    offs = torch.from_numpy(rng.uniform(
        -amp, amp, (shape[0], 6, gw, 2)).astype(np.float32)).to(dev)
    before = warp_wide.LAUNCHES
    got = warp_wide.warp_u8_offsets(frames, offs, crop)
    assert warp_wide.LAUNCHES == before + 1
    want = warp_wide.warp_u8_offsets_plain(frames, offs, crop)
    torch.cuda.synchronize()
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
    assert got.shape == frames.shape and got.dtype == torch.uint8
    assert int(diff.max()) <= 1


def test_warp_u8_offsets_noncontiguous_frames(dev):
    rng = np.random.default_rng(8)
    base = torch.from_numpy(
        rng.integers(0, 256, (2, 40, 300, 3), dtype=np.uint8)).to(dev)
    frames = base[:, :, ::2]                       # strided view
    offs = torch.zeros((2, 4, 4, 2), device=dev)
    got = warp_wide.warp_u8_offsets(frames, offs)
    torch.cuda.synchronize()
    # Identity offsets: the warp reproduces the frames exactly.
    assert torch.equal(got, frames.contiguous())
