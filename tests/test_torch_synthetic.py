"""train/synthetic.py of the port against the JAX package: every
deterministic function on shared numpy poses and stills (1e-5), and the
statistics and determinism of the functions that draw."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dvsg_tpu.train import synthetic as jsyn
from dvsg_tpu_torch.train import synthetic as tsyn

ATOL = 1e-5


def _paths(seed, *shape):
    rng = np.random.default_rng(seed)
    scale = np.array([0.08, 0.08, 0.05, 0.02, 0.02], np.float32)
    return (rng.uniform(-1, 1, (*shape, 5)).astype(np.float32) * scale)


def _close(ours, want, atol=ATOL):
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def test_jitter_theta_batched():
    p = _paths(0, 3, 4)
    want = jax.vmap(jax.vmap(jsyn.jitter_theta))(jnp.asarray(p))
    _close(tsyn.jitter_theta(torch.from_numpy(p)), want)
    _close(tsyn.jitter_theta(torch.from_numpy(p[0, 0])),
           jsyn.jitter_theta(jnp.asarray(p[0, 0])))


def test_similarity_theta():
    rng = np.random.default_rng(1)
    p = rng.uniform(-0.1, 0.1, (6, 4)).astype(np.float32)
    want = jax.vmap(jsyn.similarity_theta)(jnp.asarray(p))
    _close(tsyn.similarity_theta(torch.from_numpy(p)), want)


def test_invert_and_compose_theta():
    a = np.array(jax.vmap(jsyn.jitter_theta)(jnp.asarray(_paths(2, 7))))
    b = np.array(jax.vmap(jsyn.jitter_theta)(jnp.asarray(_paths(3, 7))))
    _close(tsyn.invert_theta(torch.from_numpy(a)),
           jax.vmap(jsyn.invert_theta)(jnp.asarray(a)), atol=1e-6)
    _close(tsyn.compose_theta(torch.from_numpy(a), torch.from_numpy(b)),
           jax.vmap(jsyn.compose_theta)(jnp.asarray(a), jnp.asarray(b)),
           atol=1e-6)
    # a homography that is not near the identity
    rng = np.random.default_rng(4)
    m = (np.eye(3) + 0.3 * rng.standard_normal((5, 3, 3))
         ).astype(np.float32)
    _close(tsyn.invert_theta(torch.from_numpy(m)),
           jax.vmap(jsyn.invert_theta)(jnp.asarray(m)), atol=1e-4)


def test_stabilizing_theta_and_offsets():
    win = _paths(5, 2, 3, 5)                  # (B, S, n, 5)
    want_t = jax.vmap(jax.vmap(jsyn.stabilizing_theta))(jnp.asarray(win))
    ours_t = tsyn.stabilizing_theta(torch.from_numpy(win))
    _close(ours_t, want_t, atol=1e-6)
    want_o = jax.vmap(jax.vmap(
        lambda t: jsyn.theta_to_offsets(t, 8, 16)))(want_t)
    _close(tsyn.theta_to_offsets(ours_t, 8, 16), want_o, atol=1e-6)


def test_jitter_frame_and_frames():
    rng = np.random.default_rng(6)
    still = rng.random((24, 40, 3), dtype=np.float32)
    p = _paths(7, 20)                         # more than one render chunk
    want = jax.vmap(lambda q: jsyn.jitter_frame(jnp.asarray(still), q))(
        jnp.asarray(p))
    _close(tsyn.jitter_frames(torch.from_numpy(still), torch.from_numpy(p)),
           want)
    _close(tsyn.jitter_frame(torch.from_numpy(still),
                             torch.from_numpy(p[3])), want[3])
    assert tsyn.jitter_frames(torch.from_numpy(still),
                              torch.from_numpy(p[:0])).shape == (0, 24, 40,
                                                                 3)


@pytest.mark.parametrize("h,w", [(32, 32), (48, 64)])
def test_still_from_octaves_matches_random_still(h, w):
    """The reference's own draws, fed to the port's deterministic half."""
    key = jax.random.key(8)
    coarses = [np.array(jax.random.uniform(
        jax.random.fold_in(key, i), (res, res, 3)))
        for i, (res, _) in enumerate(tsyn.STILL_OCTAVES)]
    want = jsyn.random_still(key, h, w)
    ours = tsyn.still_from_octaves([torch.from_numpy(c) for c in coarses],
                                   h, w)
    _close(ours, want)
    # batched: normalization is per image
    both = tsyn.still_from_octaves(
        [torch.from_numpy(np.stack([c, 0.5 * c])) for c in coarses], h, w)
    _close(both[0], want)
    assert float(both[1].max()) == pytest.approx(1.0)


def test_camera_path_from_draws_matches_reference():
    key = jax.random.key(9)
    k1, k2 = jax.random.split(key)
    steps = np.array(jax.random.normal(k1, (6 + 8, 5)))
    mag = np.array(jax.random.uniform(k2, (5,), minval=0.3, maxval=1.0))
    want = jsyn.random_camera_path(key, 6)
    ours = tsyn.camera_path_from_draws(torch.from_numpy(steps),
                                       torch.from_numpy(mag))
    _close(ours, want, atol=1e-6)


def test_random_camera_path_statistics_and_determinism():
    g = torch.Generator().manual_seed(3)
    p = tsyn.random_camera_path(g, 40, batch=(64,))
    assert p.shape == (64, 40, 5)
    bounds = torch.tensor([0.08, 0.08, 0.05, 0.02, 0.02])
    peak = p.abs().amax(dim=1)                               # (64, 5)
    assert torch.all(peak <= bounds + 1e-7)
    assert torch.all(peak >= 0.3 * bounds - 1e-7)
    assert p.mean(dim=1).abs().max() < 1e-6                  # centered
    # smooth: the mean frame-to-frame step is small beside the peak
    assert (p.diff(dim=1).abs().mean(dim=1) < 0.25 * peak).all()
    q = tsyn.random_camera_path(torch.Generator().manual_seed(3), 40,
                                batch=(64,))
    assert torch.equal(p, q)
    r = tsyn.random_camera_path(torch.Generator().manual_seed(4), 40,
                                batch=(64,))
    assert not torch.equal(p, r)
    assert tsyn.random_camera_path(g, 5).shape == (5, 5)


def test_random_still_statistics_and_determinism():
    s = tsyn.random_still(torch.Generator().manual_seed(5), 32, 48,
                          batch=(4,))
    assert s.shape == (4, 32, 48, 3) and s.dtype == torch.float32
    assert torch.all(s.amin(dim=(1, 2, 3)) == 0.0)
    assert torch.allclose(s.amax(dim=(1, 2, 3)), torch.ones(4))
    assert 0.25 < float(s.mean()) < 0.75
    t = tsyn.random_still(torch.Generator().manual_seed(5), 32, 48,
                          batch=(4,))
    assert torch.equal(s, t)
    assert not torch.equal(s[0], s[1])


def test_synthetic_clip_u8():
    frames, still, path = tsyn.synthetic_clip_u8(
        torch.Generator().manual_seed(6), 6, 32, 48)
    assert frames.shape == (6, 32, 48, 3) and frames.dtype == torch.uint8
    assert still.shape == (32, 48, 3) and still.dtype == torch.uint8
    assert path.shape == (6, 5)
    assert not torch.equal(frames[0], frames[-1])       # the camera moved
    # half to even, as the reference's round
    assert tsyn.to_u8(torch.tensor([0.5 / 255, 1.5 / 255, 2.5 / 255,
                                    -1.0, 2.0])).tolist() == [0, 2, 2, 0,
                                                              255]
