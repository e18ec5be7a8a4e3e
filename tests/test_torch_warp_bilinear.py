"""The port's dense-grid warps (ops/warp_bilinear.py, warp_wide.warp_u8_batch)
against the reference: the Pallas kernels in interpret mode and the lax
oracle, on the same numpy inputs.

On the CPU the port's wrappers run their plain versions; the CUDA kernels
are held against these on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dvsg_tpu.ops import grid as jgrid
from dvsg_tpu.ops import warp_pallas as jpallas
from dvsg_tpu.ops import warp_ref as jref
from dvsg_tpu.ops import warp_wide as jwide
from dvsg_tpu_torch.ops import warp as twarp
from dvsg_tpu_torch.ops import warp_bilinear as twb
from dvsg_tpu_torch.ops import warp_wide as twide

# f32 values in [0, 1]: the packages order the four-tap lerp differently, a
# few ulp apart.
ATOL_VALUE = 1e-5
# The reference's Pallas kernel adds its horizontal padding (>= 128 px) to
# the pixel coordinate before taking the fraction, which costs it fraction
# bits: it sits up to ~2e-5 from its own oracle, and the reference's tests
# hold it to 2e-4. The port is held to the oracle at ATOL_VALUE and to the
# Pallas kernel at the reference's own tolerance.
ATOL_PALLAS = 2e-4
# Grid gradients carry the factor 0.5 * (S - 1) (~70 here) on sums of three
# products: a few 1e-6 of rounding.
ATOL_GRAD = 1e-4
# The Pallas kernel's coordinate rounding (above) reaches its gradient
# through the same factor: up to ~3e-3 on gradients of size ~100. The
# reference's own test holds its kernel to its oracle at this tolerance.
ATOL_GRAD_PALLAS = 5e-3


def _ident(h, w):
    return np.asarray(jgrid.identity_grid(h, w))


def _dense_case(seed, b, h, w, scale):
    rng = np.random.default_rng(seed)
    frames = rng.random((b, h, w, 3), dtype=np.float32)
    grids = _ident(h, w)[None] + (
        rng.random((b, h, w, 2), dtype=np.float32) - 0.5) * scale
    return frames, grids.astype(np.float32)


def _cases():
    rng = np.random.default_rng(11)
    f = rng.random((1, 24, 128, 3), dtype=np.float32)
    yield "identity", f, _ident(24, 128)[None].copy(), 126
    yield ("dense_16x128",) + _dense_case(1, 2, 16, 128, 0.4) + (126,)
    yield ("dense_30x100",) + _dense_case(2, 2, 30, 100, 0.4) + (126,)
    f, g = _dense_case(3, 1, 32, 128, 0.1)
    yield "out_of_range_clamp", f, g * 3.0, 200
    f = rng.random((1, 32, 512, 3), dtype=np.float32)
    g = _ident(32, 512) + np.array([300 * 2.0 / 511, 0.0], np.float32)
    yield "large_constant_shift", f, g[None], 310
    f = rng.random((1, 64, 128, 3), dtype=np.float32)
    g = _ident(64, 128) + np.array([0.0, 0.9], np.float32)
    yield "large_vertical_shift", f, g[None], 126
    f = rng.random((1, 40, 150, 3), dtype=np.float32)
    yield "non_square_output", f, _ident(24, 100)[None] * 0.7, 126


CASES = {c[0]: c[1:] for c in _cases()}


@pytest.mark.parametrize("name", list(CASES))
def test_warp_batch_matches_pallas_and_oracle(name):
    frames, grids, max_dx = CASES[name]
    grids = np.ascontiguousarray(grids, np.float32)
    got = twarp.warp_batch(torch.from_numpy(frames),
                           torch.from_numpy(grids)).numpy()
    assert got.shape == grids.shape[:3] + (3,) and got.dtype == np.float32
    oracle = np.asarray(jref.bilinear_warp_batch(jnp.asarray(frames),
                                                 jnp.asarray(grids)))
    np.testing.assert_allclose(got, oracle, rtol=0, atol=ATOL_VALUE)
    pallas = np.asarray(jpallas.bilinear_warp_batch(
        jnp.asarray(frames), jnp.asarray(grids), max_dx_px=max_dx,
        interpret=True))
    print(f"warp_batch[{name}]: max |diff| {np.abs(got - oracle).max():.2e} "
          f"from the lax oracle, {np.abs(got - pallas).max():.2e} from the "
          f"Pallas kernel")
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL_PALLAS)


def test_warp_batch_takes_no_gradient_and_keeps_dtype():
    frames, grids = _dense_case(4, 1, 8, 16, 0.3)
    g = torch.from_numpy(grids).requires_grad_()
    out = twarp.warp_batch(torch.from_numpy(frames).to(torch.float64), g)
    assert out.dtype == torch.float64 and not out.requires_grad
    with pytest.raises(ValueError):
        twarp.warp_batch(torch.from_numpy(frames), g[..., :1])
    with pytest.raises(ValueError):
        twarp.warp_batch((torch.from_numpy(frames) * 255).to(torch.uint8), g)


def _grad_case(seed=5, b=2, h=24, w=136, scale=0.3, spill=1.0):
    frames, grids = _dense_case(seed, b, h, w, scale)
    rng = np.random.default_rng(seed + 100)
    tgt = rng.random(frames.shape, dtype=np.float32)
    return frames, (grids * spill).astype(np.float32), tgt


def _torch_loss_grad(frames, grids, tgt):
    f = torch.from_numpy(frames).requires_grad_()
    g = torch.from_numpy(grids).requires_grad_()
    out = twarp.warp_batch_diff(f, g)
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    return out.detach().numpy(), g.grad.numpy(), f.grad


@pytest.mark.parametrize("spill", [1.0, 1.15])
def test_warp_batch_diff_matches_pallas_vjp_on_all_pixels(spill):
    """Value and grid gradient against jax.grad through the reference's
    Pallas custom VJP, on every pixel: ``spill`` > 1 pushes coordinates
    past both borders, where the clamp's mask must zero the gradient."""
    frames, grids, tgt = _grad_case(spill=spill)
    out, dgrids, dframes = _torch_loss_grad(frames, grids, tgt)
    assert dframes is None                 # grids-only contract

    def loss(g):
        o = jpallas.bilinear_warp_batch_grids_diff(
            jnp.asarray(frames), g, 126, jpallas.TILE_H, True,
            guarded=False)
        return jnp.sum((o - tgt) ** 2), o

    (_, want_out), want = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(grids))
    np.testing.assert_allclose(out, np.asarray(want_out), rtol=0,
                               atol=ATOL_PALLAS)
    np.testing.assert_allclose(
        out, np.asarray(jref.bilinear_warp_batch(jnp.asarray(frames),
                                                 jnp.asarray(grids))),
        rtol=0, atol=ATOL_VALUE)
    print(f"warp_batch_diff[spill {spill}]: dgrids max |diff| "
          f"{np.abs(dgrids - np.asarray(want)).max():.2e} of max |dgrid| "
          f"{np.abs(np.asarray(want)).max():.1f} (Pallas VJP); value "
          f"{np.abs(out - np.asarray(want_out)).max():.2e}")
    np.testing.assert_allclose(dgrids, np.asarray(want), rtol=1e-3,
                               atol=ATOL_GRAD_PALLAS)
    if spill > 1.0:
        x = (grids[..., 0] + 1) * 0.5 * (frames.shape[2] - 1)
        held = (x <= 0) | (x >= frames.shape[2] - 1)
        assert held.any() and np.all(dgrids[..., 0][held] == 0.0)


def test_warp_batch_diff_matches_lax_oracle_on_the_interior():
    """Against full autodiff through the lax oracle, away from integer
    coordinates and the border (the subgradients differ there)."""
    frames, grids, tgt = _grad_case(seed=6)
    _, dgrids, _ = _torch_loss_grad(frames, grids, tgt)
    want = np.asarray(jax.grad(lambda g: jnp.sum(
        (jref.bilinear_warp_batch(jnp.asarray(frames), g) - tgt) ** 2))(
            jnp.asarray(grids)))
    h, w = frames.shape[1:3]
    x = (grids[..., 0] + 1) * 0.5 * (w - 1)
    y = (grids[..., 1] + 1) * 0.5 * (h - 1)
    interior = ((x % 1 > 1e-3) & (x % 1 < 1 - 1e-3)
                & (y % 1 > 1e-3) & (y % 1 < 1 - 1e-3)
                & (x > 0.5) & (x < w - 1.5) & (y > 0.5) & (y < h - 1.5))
    assert interior.mean() > 0.8
    np.testing.assert_allclose(dgrids[interior], want[interior],
                               rtol=0, atol=ATOL_GRAD)


def test_warp_batch_diff_finite_differences_float64():
    """Central differences in float64 through the plain version, on grids
    kept away from integer coordinates (kinks) and inside the frame."""
    rng = np.random.default_rng(7)
    h, w, ho, wo = 9, 11, 6, 7
    frames = torch.from_numpy(rng.random((2, h, w, 3)))
    # pixel coordinates k + [0.2, 0.8]: no tie within the step
    px = rng.integers(0, w - 1, (2, ho, wo)) + rng.uniform(0.2, 0.8,
                                                           (2, ho, wo))
    py = rng.integers(0, h - 1, (2, ho, wo)) + rng.uniform(0.2, 0.8,
                                                           (2, ho, wo))
    grids = torch.from_numpy(np.stack(
        [px / (w - 1) * 2 - 1, py / (h - 1) * 2 - 1], -1)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda g: twarp.warp_batch_diff(frames, g), (grids,), eps=1e-6,
        atol=1e-6)


def test_warp_batch_diff_without_grad_is_the_plain_warp():
    frames, grids, _ = _grad_case(seed=8, b=1, h=8, w=16)
    f, g = torch.from_numpy(frames), torch.from_numpy(grids)
    out = twarp.warp_batch_diff(f, g)            # grids need no gradient
    assert not out.requires_grad
    torch.testing.assert_close(out, twarp.warp_batch(f, g), rtol=0, atol=0)
    with torch.no_grad():
        out2 = twarp.warp_batch_diff(f, g.clone().requires_grad_())
    torch.testing.assert_close(out2, out, rtol=0, atol=0)


def test_derivative_images_are_zero_at_the_far_border():
    """The second tap is clamped, so it equals the first at the right and
    bottom borders and the derivative there is 0, as with the reference's
    replication padding; so is the gradient the backward recomputes."""
    rng = np.random.default_rng(9)
    frames = torch.from_numpy(rng.random((1, 6, 7, 3), dtype=np.float32))
    grids = torch.from_numpy(_ident(6, 7)[None].copy())
    out, dx, dy = twb.warp_diff_forward_plain(frames, grids)
    assert torch.all(dx[:, :, -1] == 0) and torch.all(dy[:, -1] == 0)
    assert dx[:, :, :-1].abs().max() > 0
    torch.testing.assert_close(twb.warp_diff_forward(frames, grids), out,
                               rtol=0, atol=0)
    cot = torch.from_numpy(rng.standard_normal((1, 6, 7, 3)).astype(
        np.float32))
    dgrids = twb.warp_diff_backward(cot, frames, grids)
    assert torch.all(dgrids[:, :, -1, 0] == 0)
    assert torch.all(dgrids[:, -1, :, 1] == 0)
    assert dgrids[:, 1:-1, 1:-1].abs().min() > 0
    with pytest.raises(ValueError, match="one warp"):
        twb.warp_diff_backward(cot[:, :-1], frames, grids)


@pytest.mark.parametrize("spill", [1.0, 1.15])
def test_grid_grad_plain_is_the_two_plain_halves_and_the_pallas_vjp(spill):
    """The backward's plain version (cotangent, frames, grids → dgrids)
    equals the contraction half applied to the forward half's derivative
    images to the bit, is what autograd returns, and agrees with the
    reference's Pallas custom VJP on a random cotangent."""
    frames, grids, _ = _grad_case(seed=12, spill=spill)
    rng = np.random.default_rng(13)
    cot = rng.standard_normal(frames.shape).astype(np.float32)
    f, g, c = (torch.from_numpy(a) for a in (frames, grids, cot))
    got = twb.warp_diff_grid_grad_plain(c, f, g)
    _, dx, dy = twb.warp_diff_forward_plain(f, g)
    halves = twb.warp_diff_backward_plain(c, dx, dy, g, *frames.shape[1:3])
    torch.testing.assert_close(got, halves, rtol=0, atol=0)
    torch.testing.assert_close(twb.warp_diff_backward(c, f, g), got,
                               rtol=0, atol=0)
    for fn in (twb.bilinear_warp_batch_grids_diff,
               twb.bilinear_warp_batch_grids_diff_plain):
        gr = g.clone().requires_grad_()
        fn(f, gr).backward(c)
        torch.testing.assert_close(gr.grad, got, rtol=0, atol=0)

    _, vjp = jax.vjp(lambda gg: jpallas.bilinear_warp_batch_grids_diff(
        jnp.asarray(frames), gg, 126, jpallas.TILE_H, True, guarded=False),
        jnp.asarray(grids))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    print(f"grid_grad_plain[spill {spill}]: max |diff| "
          f"{np.abs(got.numpy() - want).max():.2e} of max |dgrid| "
          f"{np.abs(want).max():.1f} (Pallas VJP)")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                               atol=ATOL_GRAD_PALLAS)


@pytest.mark.parametrize("fn", ["dispatch", "plain"])
def test_warp_batch_diff_keeps_no_derivative_image(fn):
    """The forward under grad keeps the frames and the grids for the
    backward and nothing else: no (B, Ho, Wo, C) derivative image."""
    frames, grids, _ = _grad_case(seed=14, b=2, h=10, w=20)
    grids = np.ascontiguousarray(grids[:, :7, :9])      # Ho, Wo != H, W
    f = torch.from_numpy(frames)
    g = torch.from_numpy(grids).requires_grad_()
    warp = {"dispatch": twb.bilinear_warp_batch_grids_diff,
            "plain": twb.bilinear_warp_batch_grids_diff_plain}[fn]
    out = warp(f, g)
    assert out.shape == (2, 7, 9, 3)
    kept = sorted(tuple(t.shape) for t in out.grad_fn.saved_tensors)
    assert kept == sorted([tuple(f.shape), tuple(g.shape)])


@pytest.mark.parametrize("h,w,ho,wo,scale", [(24, 128, 24, 128, 0.3),
                                              (40, 150, 24, 100, 0.5),
                                              (16, 136, 16, 136, 2.5)])
def test_warp_u8_batch_within_one_lsb(h, w, ho, wo, scale):
    rng = np.random.default_rng(h + wo)
    frames = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    grids = (_ident(ho, wo)[None] * 0.9 + (rng.random(
        (2, ho, wo, 2), dtype=np.float32) - 0.5) * scale * 0.2
             ).astype(np.float32)
    if scale > 1:
        grids *= 1.3                        # out of range on both sides
    got = twarp.warp_quantize_batch(torch.from_numpy(frames),
                                    grids=torch.from_numpy(grids))
    assert got.dtype == torch.uint8 and got.shape == (2, ho, wo, 3)
    got = got.numpy().astype(int)
    oracle = np.asarray(jref.warp_quantize_oracle(
        jnp.asarray(frames), jnp.asarray(grids))).astype(int)
    pallas = np.asarray(jwide.warp_u8_batch(
        jnp.asarray(frames), jnp.asarray(grids), interpret=True)
        ).astype(int)
    for name, want in (("oracle", oracle), ("pallas", pallas)):
        diff = np.abs(got - want)
        print(f"warp_u8_batch {h}x{w}->{ho}x{wo} vs {name}: max "
              f"{diff.max()} LSB, {(diff > 0).mean():.2e} of values differ")
        assert diff.max() <= 1
        assert (diff > 0).mean() < 0.01
    torch.testing.assert_close(
        twide.warp_u8_batch_plain(torch.from_numpy(frames),
                                  torch.from_numpy(grids)).to(torch.int64),
        torch.from_numpy(got), rtol=0, atol=0)
