"""The port's CUDA kernels on the card, held against their plain versions.

Marked ``cuda``: they skip on a machine without a CUDA card. On the card
they run without the JAX side of the suite (no jax is needed there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from dvsg_tpu_torch.ops import warp_bilinear, warp_wide

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


# --- the dense-grid warps ------------------------------------------------------

def _grids(rng, b, ho, wo, spill, dev):
    """Smooth grids around the identity, scaled by ``spill`` (> 1 leaves
    the frame on both sides)."""
    ys, xs = np.meshgrid(np.linspace(-1, 1, ho), np.linspace(-1, 1, wo),
                         indexing="ij")
    base = np.stack([xs, ys], -1)[None]
    g = (base + rng.uniform(-0.2, 0.2, (b, ho, wo, 2))) * spill
    return torch.from_numpy(g.astype(np.float32)).to(dev)


SHAPES = [((2, 37, 150, 3), (37, 150), 1.0),
          ((2, 37, 150, 3), (23, 61), 1.3),       # output size != input's
          ((3, 64, 96, 1), (64, 96), 1.0),
          ((1, 33, 257, 4), (50, 40), 2.0)]


@pytest.mark.parametrize("shape,out_hw,spill", SHAPES)
def test_warp_f32_kernel_matches_plain(dev, shape, out_hw, spill):
    rng = np.random.default_rng(9)
    frames = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
    grids = _grids(rng, shape[0], *out_hw, spill, dev)
    before = warp_bilinear.LAUNCHES_WARP
    got = warp_bilinear.bilinear_warp_batch(frames, grids)
    assert warp_bilinear.LAUNCHES_WARP == before + 1
    want = warp_bilinear.bilinear_warp_batch_plain(frames, grids)
    torch.cuda.synchronize()
    assert got.shape == (shape[0], *out_hw, shape[3])
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("shape,out_hw,spill", SHAPES)
def test_warp_f32_diff_kernels_match_plain(dev, shape, out_hw, spill):
    """Values, derivative images and the grid cotangent of the
    differentiable warp: forward and backward kernels against the plain
    autograd.Function's halves."""
    rng = np.random.default_rng(10)
    frames = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
    grids = _grids(rng, shape[0], *out_hw, spill, dev).requires_grad_()
    cot = torch.from_numpy(rng.standard_normal(
        (shape[0], *out_hw, shape[3])).astype(np.float32)).to(dev)
    fwd, bwd = (warp_bilinear.LAUNCHES_DIFF_FWD,
                warp_bilinear.LAUNCHES_DIFF_BWD)
    out = warp_bilinear.bilinear_warp_batch_grids_diff(frames, grids)
    out.backward(cot)
    assert warp_bilinear.LAUNCHES_DIFF_FWD == fwd + 1
    assert warp_bilinear.LAUNCHES_DIFF_BWD == bwd + 1
    g = grids.detach()
    o_k, dx_k, dy_k = warp_bilinear.warp_diff_forward(frames, g)
    o_p, dx_p, dy_p = warp_bilinear.warp_diff_forward_plain(frames, g)
    want = warp_bilinear.warp_diff_backward_plain(
        cot, dx_p, dy_p, g, shape[1], shape[2])
    torch.cuda.synchronize()
    assert float((out.detach() - o_p).abs().max()) <= 1e-5
    assert float((o_k - o_p).abs().max()) <= 1e-5
    assert float((dx_k - dx_p).abs().max()) <= 1e-5
    assert float((dy_k - dy_p).abs().max()) <= 1e-5
    scale = 0.5 * (max(shape[1], shape[2]) - 1)
    assert float((grids.grad - want).abs().max()) <= 1e-5 * scale * shape[3]


def test_warp_f32_diff_frames_get_no_gradient(dev):
    rng = np.random.default_rng(11)
    frames = torch.from_numpy(
        rng.random((1, 16, 24, 3), dtype=np.float32)).to(dev).requires_grad_()
    grids = _grids(rng, 1, 16, 24, 1.0, dev).requires_grad_()
    warp_bilinear.bilinear_warp_batch_grids_diff(frames, grids).sum(
        ).backward()
    assert frames.grad is None and grids.grad is not None


@pytest.mark.parametrize("shape,out_hw,spill", SHAPES)
def test_warp_u8_batch_kernel_matches_plain(dev, shape, out_hw, spill):
    rng = np.random.default_rng(12)
    frames = torch.from_numpy(
        rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
    grids = _grids(rng, shape[0], *out_hw, spill, dev)
    before = warp_wide.LAUNCHES_BATCH
    got = warp_wide.warp_u8_batch(frames, grids)
    assert warp_wide.LAUNCHES_BATCH == before + 1
    want = warp_wide.warp_u8_batch_plain(frames, grids)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8
    assert got.shape == (shape[0], *out_hw, shape[3])
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
    assert int(diff.max()) <= 1


def test_train_step_on_the_card_matches_the_cpu(dev):
    """One small train step through the kernels on the card against the
    same step through the plain versions on the CPU."""
    from dvsg_tpu_torch.config import ModelConfig, TrainConfig
    from dvsg_tpu_torch.models import motion_cnn
    from dvsg_tpu_torch.train import loop
    mcfg = ModelConfig(window=3, model_size=(32, 32), grid_size=(8, 8),
                       base_features=8, blocks_per_level=1)
    cfg = TrainConfig(model=mcfg, batch_size=2, steps=4, warmup_steps=1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    params = motion_cnn.init_params(mcfg, gen)
    params["head_out.weight"] = 0.05 * torch.randn(
        params["head_out.weight"].shape, generator=gen)
    totals = {}
    for device in ("cpu", "cuda"):
        state = loop.build_state(cfg, params, device=device)
        total, _ = loop.loss_fn(state.model, loop.step_generator(0, 0), cfg)
        total.backward()
        totals[device] = (float(total.detach()), {
            n: p.grad.cpu() for n, p in state.model.named_parameters()})
    assert totals["cuda"][0] == pytest.approx(totals["cpu"][0], rel=1e-4)
    for n, g in totals["cpu"][1].items():
        scale = float(g.abs().max())
        assert float((totals["cuda"][1][n] - g).abs().max()) <= 1e-3 * scale
