"""Resize matrices and warp grids of the port against the JAX package.

``_resize_matrix`` is rebuilt in numpy from jax.image.resize's weight
formula; it must equal the reference's (extracted from jax.image.resize
itself) to 1e-6 for every shape pair the pipeline uses. ``downscale_norm``
and ``grid_from_offsets`` hold 2e-5 (f32 matmul accumulation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvsg_tpu.ops import grid as jgrid
from dvsg_tpu.ops import resize as jresize
from dvsg_tpu_torch.ops import grid as tgrid
from dvsg_tpu_torch.ops import resize as tresize

# (n_in, n_out): frame rows/cols → model res (128 fast, 256 quality), grid
# rows/cols → frame res, and the test sizes below.
PAIRS = [(720, 128), (720, 256), (1280, 128), (1280, 256), (16, 720),
         (16, 1280), (480, 128), (854, 256), (16, 480), (16, 854),
         (64, 128), (96, 128), (40, 32), (150, 48), (8, 40), (8, 150),
         (6, 37), (3, 3), (5, 1)]


@pytest.mark.parametrize("n_in,n_out", PAIRS)
def test_resize_matrix_matches_reference(n_in, n_out):
    ours = tresize._resize_matrix(n_in, n_out)
    ref = jresize._resize_matrix(n_in, n_out)
    assert ours.shape == ref.shape == (n_out, n_in)
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_resize_matrix_is_read_only():
    m = tresize._resize_matrix(16, 40)
    with pytest.raises(ValueError):
        m[0, 0] = 1.0


@pytest.mark.parametrize("shape,out", [((3, 40, 150, 3), (32, 48)),
                                       ((2, 64, 96, 3), (128, 128)),
                                       ((1, 37, 53, 1), (16, 16))])
def test_downscale_norm_matches_reference(shape, out):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, shape, dtype=np.uint8)
    ref = np.asarray(jresize.downscale_norm(jnp.asarray(frames), *out))
    ours = tresize.downscale_norm(torch.from_numpy(frames), *out).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-5)


def test_downscale_bilinear_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 150, 3)).astype(np.float32)
    ref = np.asarray(jresize.downscale_bilinear(jnp.asarray(x), 20, 64))
    ours = tresize.downscale_bilinear(torch.from_numpy(x), 20, 64).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("h,w", [(40, 150), (7, 5), (720, 1280)])
def test_identity_grid_matches_reference(h, w):
    ref = np.asarray(jgrid.identity_grid(h, w))
    ours = tgrid.identity_grid(h, w).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("crop", [0.0, 0.05, 0.1])
def test_grid_from_offsets_matches_reference(crop):
    rng = np.random.default_rng(2)
    offs = rng.uniform(-0.2, 0.2, (3, 8, 8, 2)).astype(np.float32)
    ref = np.stack([np.asarray(jgrid.grid_from_offsets(
        jnp.asarray(o), 40, 150, border_crop=crop)) for o in offs])
    ours = tgrid.grid_from_offsets(torch.from_numpy(offs), 40, 150,
                                   border_crop=crop).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-5)


def test_upsample_offsets_matches_reference():
    rng = np.random.default_rng(3)
    offs = rng.uniform(-0.2, 0.2, (16, 16, 2)).astype(np.float32)
    ref = np.asarray(jgrid.upsample_offsets(jnp.asarray(offs), 72, 128))
    ours = tgrid.upsample_offsets(torch.from_numpy(offs), 72, 128).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("crop", [-0.01, 0.5, 0.75])
def test_grid_from_offsets_rejects_bad_crop(crop):
    with pytest.raises(ValueError, match="border_crop"):
        tgrid.grid_from_offsets(torch.zeros(4, 4, 2), 8, 8, border_crop=crop)


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"


# --- the training path's grids and the bicubic operator ----------------------

def test_grid_to_pixel_coords_matches_reference():
    rng = np.random.default_rng(20)
    g = rng.uniform(-1.3, 1.3, (2, 5, 7, 2)).astype(np.float32)
    for ours, want in zip(
            tgrid.grid_to_pixel_coords(torch.from_numpy(g), 37, 150),
            jgrid.grid_to_pixel_coords(jnp.asarray(g), 37, 150)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("h,w", [(8, 8), (32, 32), (37, 150)])
def test_affine_and_homography_grids_match_reference(h, w):
    """Batched over a leading axis in the port; the reference vmaps."""
    rng = np.random.default_rng(21)
    theta = (np.eye(3)[None] + 0.05 * rng.standard_normal((4, 3, 3))
             ).astype(np.float32)
    theta[:, 2, 2] = 1.0
    want_h = jax.vmap(lambda t: jgrid.homography_grid(t, h, w))(
        jnp.asarray(theta))
    ours_h = tgrid.homography_grid(torch.from_numpy(theta), h, w)
    assert ours_h.shape == (4, h, w, 2)
    np.testing.assert_allclose(ours_h.numpy(), np.asarray(want_h),
                               rtol=0, atol=1e-6)
    want_a = jax.vmap(lambda t: jgrid.affine_grid(t, h, w))(
        jnp.asarray(theta[:, :2]))
    ours_a = tgrid.affine_grid(torch.from_numpy(theta[:, :2]), h, w)
    np.testing.assert_allclose(ours_a.numpy(), np.asarray(want_a),
                               rtol=0, atol=1e-6)
    # unbatched, and two leading axes
    np.testing.assert_allclose(
        tgrid.homography_grid(torch.from_numpy(theta[0]), h, w).numpy(),
        np.asarray(want_h[0]), rtol=0, atol=1e-6)
    assert tgrid.homography_grid(
        torch.from_numpy(theta.reshape(2, 2, 3, 3)), h, w).shape \
        == (2, 2, h, w, 2)


@pytest.mark.parametrize("n_out", [32, 128, 256])
@pytest.mark.parametrize("n_in", [4, 8, 16, 64])
def test_bicubic_matches_jax_image_resize(n_in, n_out):
    """The still generator's upsample: Keys a = -0.5 with border weights
    renormalized, not F.interpolate's a = -0.75 with clamped taps."""
    rng = np.random.default_rng(n_in + n_out)
    x = rng.random((n_in, n_in, 3), dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (n_out, n_out, 3),
                                       method="bicubic"))
    ours = tresize.resize_bicubic(torch.from_numpy(x), n_out, n_out).numpy()
    print(f"bicubic {n_in} -> {n_out}: max |diff| "
          f"{np.abs(ours - want).max():.2e}")
    np.testing.assert_allclose(ours, want, rtol=0, atol=1e-5)
    if n_out > n_in:
        torch_own = torch.nn.functional.interpolate(
            torch.from_numpy(x).permute(2, 0, 1)[None], (n_out, n_out),
            mode="bicubic", align_corners=False)[0].permute(1, 2, 0).numpy()
        assert np.abs(torch_own - want).max() > 1e-3    # why it is not used


def test_bicubic_batched_and_rectangular():
    rng = np.random.default_rng(22)
    x = rng.random((2, 3, 8, 16, 3), dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, 40, 24, 3),
                                       method="bicubic"))
    ours = tresize.resize_bicubic(torch.from_numpy(x), 40, 24).numpy()
    np.testing.assert_allclose(ours, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        tresize._resize_matrix(4, 8, "lanczos")
