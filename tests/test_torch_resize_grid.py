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
