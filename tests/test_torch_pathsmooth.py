"""Camera-path smoothing of the port (pipeline/pathsmooth.py and the
smoothed chunk steps) against the JAX package on the CPU, and against
itself (mirrors of tests/test_pathsmooth.py).

Tolerances, as measured on the CPU against ``dvsg_tpu`` (``pytest -s``
prints the parity tests' readings): the shape-only tables are bit-equal;
``_phase_shifts_px`` agrees to 1.3-2.7e-6 px with the same integer and
1/8-px peaks (held to 1e-4 px) and its confidence to 1.1-6.4e-5 relative
(held to 1e-4); ``measure`` to 4.4e-8 normalized units (held to 1e-6); the
recursion, the lag FIR and the correction fields to f32 rounding (1e-6,
1e-7). ``Stabilizer.stabilize_clip`` is within 1 LSB of the reference's
(lax warp) in every mode, on 2.6e-4 to 8.9e-4 of values: the FFTs round
differently, which moves a pixel only where its value sits on a rounding
boundary.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvsg_tpu.config import ModelConfig as JModelConfig
from dvsg_tpu.config import StabilizeConfig as JStabilizeConfig
from dvsg_tpu.ops import grid as jgrid
from dvsg_tpu.ops import resize as jresize
from dvsg_tpu.pipeline import pathsmooth as jps
from dvsg_tpu.pipeline.stabilize import Stabilizer as JStabilizer
from dvsg_tpu.train import synthetic as jsynthetic
from dvsg_tpu.utils import checkpoint as jckpt
from dvsg_tpu_torch.config import ModelConfig, StabilizeConfig
from dvsg_tpu_torch.models import motion_cnn
from dvsg_tpu_torch.ops import resize as resize_ops
from dvsg_tpu_torch.pipeline import pathsmooth as ps
from dvsg_tpu_torch.pipeline import stabilize as tstab
from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
from dvsg_tpu_torch.train import synthetic
from dvsg_tpu_torch.utils.checkpoint import load_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = os.path.join(ROOT, "checkpoints", "flagship_fast.npz")
MCFG = ModelConfig(window=3, model_size=(32, 32), grid_size=(8, 8),
                   base_features=8, blocks_per_level=1)
CFG = StabilizeConfig(model=MCFG, chunk_frames=4, path_smooth=8)
LAG_CFG = CFG.replace(path_smooth_lag=4)
# The reference-parity modes: (name, config fields).
MODES = [("causal", {}), ("lag", dict(path_smooth_lag=4)),
         ("translation", dict(path_smooth_rotation=False,
                              path_smooth_scale=False)),
         ("ungated", dict(path_smooth_conf=0.0, path_smooth_cut=0.0))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops on many intra-op threads, beside XLA's own pool and
    other test workers, oversubscribe the cores; one thread is as fast
    alone and steady under load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """The tiny model with a head that moves pixels."""
    gen = torch.Generator().manual_seed(0)
    p = motion_cnn.init_params(MCFG, gen)
    p["head_out.weight"] = 0.05 * torch.randn(p["head_out.weight"].shape,
                                              generator=gen)
    return p


@pytest.fixture(scope="module")
def fast():
    return load_npz(FAST), jckpt.load_npz(FAST)


def _clip(n, key=3, h=40, w=48):
    return synthetic.synthetic_clip_u8(torch.Generator().manual_seed(key),
                                       n, h, w)[0].numpy()


def _seq(n=12, size=96, key=1):
    """Model-resolution frames of a synthetic shaky clip (reference
    renderer), (n, size, size, 3) f32 centred at 0."""
    fr = jsynthetic.synthetic_clip_u8(jax.random.key(key), n, 160, 192)[0]
    return np.asarray(jresize.downscale_norm(fr, size, size))


# --- parity with the JAX package ------------------------------------------------

@pytest.mark.parametrize("table", ["hann", "offsets", "fftfreq",
                                   "identity_grid", "lag_taps"])
def test_tables_bit_equal_reference(table):
    cpu = torch.device("cpu")
    if table == "hann":
        for n in (16, 32, 48, 64, 128, 256):
            np.testing.assert_array_equal(ps._hann_np(n),
                                          np.asarray(jps._hann(n)))
            np.testing.assert_array_equal(
                ps._on(cpu, "hann2d", n, n // 2).numpy(),
                np.asarray(jps._hann(n)[:, None]
                           * jps._hann(n // 2)[None, :]))
    elif table == "offsets":
        np.testing.assert_array_equal(
            ps._on(cpu, "offsets").numpy(),
            np.asarray(jnp.linspace(-1.5, 1.5, 25, dtype=jnp.float32)))
    elif table == "fftfreq":
        for n in (16, 32, 64, 128, 256):
            np.testing.assert_array_equal(
                ps._on(cpu, "fftfreq", n).numpy(),
                np.asarray(jnp.fft.fftfreq(n).astype(jnp.float32)))
    elif table == "identity_grid":
        for gh, gw in ((8, 8), (16, 16), (32, 32), (6, 10)):
            np.testing.assert_array_equal(
                ps._on(cpu, "identity_grid", gh, gw).numpy(),
                np.asarray(jgrid.identity_grid(gh, gw)))
    else:
        for key in ((8, 4, 3), (32, 16, 5), (64, 0, 5), (2, 1, 9)):
            k, taps = ps._lag_taps_np(*key)
            k_ref, taps_ref = jps._lag_taps_np(*key)
            assert k == k_ref
            np.testing.assert_array_equal(taps, taps_ref)


@pytest.mark.parametrize("shape", [(32, 32), (96, 96), (64, 80)])
def test_phase_shifts_match_reference(shape):
    seq = _seq(8, 96)
    luma = np.ascontiguousarray(seq.mean(-1)[:, :shape[0], :shape[1]])
    s_ref, c_ref = (np.asarray(a) for a in
                    jax.jit(jps._phase_shifts_px)(luma))
    s, c = ps._phase_shifts_px(torch.from_numpy(luma))
    assert s.dtype == c.dtype == torch.float32
    print(f"phase shifts {shape}: {np.abs(s.numpy() - s_ref).max():.2e} px, "
          f"conf {np.abs(c.numpy() / c_ref - 1).max():.2e} relative")
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(c.numpy(), c_ref, rtol=1e-4)


@pytest.mark.parametrize("rot,scale", [(True, True), (False, True),
                                       (False, False)])
def test_measure_matches_reference(rot, scale):
    """measure (measure_motion, masked) or, translation-only,
    measure_shifts: deltas and the full-frame confidence."""
    kw = dict(path_smooth=8, path_smooth_rotation=rot,
              path_smooth_scale=scale)
    cfg = StabilizeConfig(model=MCFG, **kw)
    jcfg = JStabilizeConfig(model=JModelConfig(**vars(MCFG)), **kw)
    seq = _seq(12, 96)
    d_ref, c_ref = (np.asarray(a) for a in
                    jax.jit(lambda x: jps.measure(jcfg, x))(seq))
    d, c = ps.measure(cfg, torch.from_numpy(seq.copy()))
    assert d.shape == (11, 4)
    print(f"measure rot={rot} scale={scale}: "
          f"{np.abs(d.numpy() - d_ref).max():.2e}")
    np.testing.assert_allclose(d.numpy(), d_ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(c.numpy(), c_ref, rtol=1e-4)


@pytest.mark.parametrize("rot,scale", [(True, True), (False, True),
                                       (True, False)])
def test_apply_corrections_match_reference(rot, scale):
    kw = dict(path_smooth=8, path_smooth_rotation=rot,
              path_smooth_scale=scale)
    cfg = StabilizeConfig(model=MCFG, **kw)
    jcfg = JStabilizeConfig(model=JModelConfig(**vars(MCFG)), **kw)
    rng = np.random.default_rng(2)
    offs = rng.uniform(-0.1, 0.1, (5, 8, 8, 2)).astype(np.float32)
    e = rng.uniform(-0.05, 0.05, (5, 4)).astype(np.float32)
    want = jps.apply_corrections(jcfg, jnp.asarray(offs), jnp.asarray(e))
    got = ps.apply_corrections(cfg, torch.from_numpy(offs),
                               torch.from_numpy(e))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-7)


def test_smoothed_corrections_match_reference():
    """Gated deltas, cuts and a nonzero carried state."""
    rng = np.random.default_rng(4)
    t, n = 12, 5
    deltas = rng.normal(0, 0.02, (t + n - 2, 4)).astype(np.float32)
    conf = rng.uniform(1.0, 6.0, t + n - 2).astype(np.float32)
    state = rng.normal(0, 0.02, 4).astype(np.float32)
    kw = dict(path_smooth=16, path_smooth_max=0.03)
    cfg = StabilizeConfig(model=ModelConfig(window=n), **kw)
    jcfg = JStabilizeConfig(model=JModelConfig(window=n), **kw)
    e_ref, s_ref = jps.corrections_from_measured(
        jcfg, jnp.asarray(deltas), jnp.asarray(conf), t, jnp.asarray(state))
    e, s = ps.corrections_from_measured(
        cfg, torch.from_numpy(deltas), torch.from_numpy(conf), t,
        torch.from_numpy(state))
    assert (conf < 1.5).any() and (conf >= 2.0).any()
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-6)


def test_lag_corrections_match_reference():
    rng = np.random.default_rng(5)
    kw = dict(path_smooth=8, path_smooth_lag=4, chunk_frames=6)
    cfg = StabilizeConfig(model=MCFG, **kw)
    jcfg = JStabilizeConfig(model=JModelConfig(**vars(MCFG)), **kw)
    n_ext = ps.lag_carry_len(cfg) + 6 + MCFG.window - 1
    assert ps.lag_carry_len(cfg) == jps.lag_carry_len(jcfg)
    d = rng.normal(0, 0.02, (n_ext, 4)).astype(np.float32)
    c = rng.uniform(1.0, 6.0, n_ext).astype(np.float32)
    want = jps.lag_corrections(jcfg, jnp.asarray(d), jnp.asarray(c), 6)
    got = ps.lag_corrections(cfg, torch.from_numpy(d), torch.from_numpy(c),
                             6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _ref_stab(jparams, jmcfg, **kw):
    return JStabilizer(JStabilizeConfig(model=jmcfg, chunk_frames=4,
                                        warp_impl="lax", **kw), jparams)


@pytest.mark.parametrize("mode", [m for m, _ in MODES])
def test_clip_within_1lsb_of_reference(fast, mode):
    (params, mcfg), (jparams, jmcfg) = fast
    kw = dict(path_smooth=8, **dict(MODES)[mode])
    frames = _clip(10, key=3, h=64, w=96)
    ref = _ref_stab(jparams, jmcfg, **kw).stabilize_clip(frames)
    ours = Stabilizer(StabilizeConfig(model=mcfg, chunk_frames=4, **kw),
                      params, device="cpu").stabilize_clip(frames)
    plain = Stabilizer(StabilizeConfig(model=mcfg, chunk_frames=4), params,
                       device="cpu").stabilize_clip(frames)
    diff = np.abs(ours.astype(int) - ref)
    print(f"clip {mode}: max {diff.max()} LSB on {(diff > 0).mean():.1e} "
          f"of values")
    assert ours.shape == frames.shape and ours.dtype == np.uint8
    assert diff.max() <= 1
    assert np.abs(ours.astype(int) - plain).max() > 8   # smoothing moved it


class _Reader:
    def __init__(self, frames):
        self.frames, self.pos = frames, 0

    def read_batch(self, n):
        out = self.frames[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def skip(self, n):
        k = min(n, len(self.frames) - self.pos)
        self.pos += k
        return k


class _Writer:
    def __init__(self, n, shape, fail_at=None):
        self.frames = np.zeros((n, *shape), np.uint8)
        self.pos, self.calls, self.fail_at = 0, 0, fail_at

    def seek(self, i):
        self.pos = i

    def write_batch(self, frames):
        if self.calls == self.fail_at:
            raise RuntimeError("injected encoder failure")
        self.calls += 1
        self.frames[self.pos:self.pos + len(frames)] = frames
        self.pos += len(frames)


def _interrupted(stab, frames, resume_dir, fail_at):
    """Run a stream with a resume record until its ``fail_at``-th write
    fails; returns the writer."""
    w = _Writer(len(frames), frames.shape[1:], fail_at)
    with pytest.raises(RuntimeError, match="injected"):
        stab.stabilize_stream(_Reader(frames), w, resume_dir=resume_dir)
    return w


@pytest.mark.parametrize("mode,fail_at", [("causal", 2), ("lag", 2),
                                          ("lag", 3)])
def test_reference_record_resumes_in_the_port(fast, tmp_path, mode,
                                              fail_at):
    """A resume record written by the reference's stream (causal; lag
    mid-stream and in the drain region) resumes in the port's stream;
    the result is within 1 LSB of the reference's uninterrupted run."""
    (params, mcfg), (jparams, jmcfg) = fast
    kw = dict(path_smooth=8, **dict(MODES)[mode])
    frames = _clip(14, key=5, h=64, w=96)
    ref = _ref_stab(jparams, jmcfg, **kw)
    want = ref.stabilize_clip(frames)
    rdir = str(tmp_path / "r")
    first = _interrupted(ref, frames, rdir, fail_at)
    with np.load(os.path.join(rdir, "resume_state.npz")) as z:
        written = int(z["frames_written"])
        if mode == "lag":
            assert (int(z["lag_real"]) < 4) == (fail_at == 3)
    ours = Stabilizer(StabilizeConfig(model=mcfg, chunk_frames=4, **kw),
                      params, device="cpu")
    w = _Writer(len(frames), frames.shape[1:])
    w.frames[:written] = first.frames[:written]
    assert ours.stabilize_stream(_Reader(frames), w, resume_dir=rdir) \
        == len(frames)
    assert np.abs(w.frames.astype(int) - want).max() <= 1


# --- the port against itself ------------------------------------------------------

def _ref_corrections(deltas, n, horizon, clamp, t, d0=None, cuts=None):
    """Plain-numpy reference of the documented recursion."""
    p = np.concatenate([np.zeros((1, deltas.shape[1])),
                        np.cumsum(deltas, axis=0)])
    d = np.zeros(deltas.shape[1]) if d0 is None else np.array(d0, np.float64)
    alpha = 2.0 / (horizon + 1.0)
    es = []
    for i in range(t):
        g = i + n - 1
        rel = p[g] - p[g - n + 1:g + 1].mean(axis=0)
        d = (1 - alpha) * (d + (p[g] - p[g - 1]))
        if cuts is not None and cuts[i + n - 2]:
            d = rel.copy()
        e = np.clip(rel - d, -clamp, clamp)
        d = rel - e
        es.append(e)
    return np.array(es), d


def _corr(cfg, deltas, t, state=None, cuts=None):
    state = torch.zeros(deltas.shape[1]) if state is None else state
    e, d = ps.smoothed_corrections(
        cfg, torch.from_numpy(deltas), t, state,
        cuts=None if cuts is None else torch.from_numpy(cuts))
    return e.numpy(), d.numpy()


class TestMeasure:
    def test_integer_roll_is_exact(self):
        img = synthetic.random_still(torch.Generator().manual_seed(0), 64,
                                     64).numpy()
        rolled = np.roll(np.roll(img, 3, axis=0), -2, axis=1)
        seq = torch.from_numpy(np.stack([img, rolled]) - 0.5)
        d = ps.measure_shifts(seq)[0].numpy()[0]
        # roll(+3, axis=0): f_new(y) = f_old(y - 3) → Δy = -3 px.
        np.testing.assert_allclose(d[0], 2 * 2.0 / 63, atol=2e-3)
        np.testing.assert_allclose(d[1], -3 * 2.0 / 63, atol=2e-3)

    def test_synthetic_translation_accuracy_and_sign(self):
        gen = torch.Generator().manual_seed(1)
        path = synthetic.random_camera_path(gen, 12, max_trans=0.05,
                                            max_angle=0.0, max_persp=0.0)
        still = synthetic.random_still(gen, 160, 192)
        u8 = synthetic.to_u8(synthetic.jitter_frames(still, path))
        d = ps.measure_shifts(resize_ops.downscale_norm(u8, 96, 96))[0]
        true = np.diff(path[:, :2].numpy(), axis=0)
        assert np.abs(d.numpy() - true).max() < 0.004

    def test_confidence_discriminates_cuts_and_flat_frames(self):
        gen = torch.Generator().manual_seed(0)
        fr, _, _ = synthetic.synthetic_clip(gen, 4, 160, 192)
        other = synthetic.random_still(torch.Generator().manual_seed(99),
                                       160, 192)
        rng = np.random.default_rng(0)
        flat = torch.from_numpy(np.clip(
            0.5 + rng.normal(0, 0.006, (2, 160, 192, 3)), 0, 1
        ).astype(np.float32))
        u8 = synthetic.to_u8(torch.cat([fr, other[None], flat]))
        _, conf = ps.measure_shifts(resize_ops.downscale_norm(u8, 96, 96))
        conf = conf.numpy()
        # pairs 0-2 in one scene; 3 a cut; 4 a cut to flat; 5 flat.
        assert conf[:3].min() > 2.0 and conf[3:].max() < 1.5, conf


class TestRecursion:
    def test_matches_numpy_reference(self):
        rng = np.random.default_rng(0)
        t, n = 12, 5
        deltas = rng.normal(0, 0.01, (t + n - 2, 2)).astype(np.float32)
        cfg = StabilizeConfig(model=ModelConfig(window=n), path_smooth=32)
        e, d = _corr(cfg, deltas, t)
        e_ref, d_ref = _ref_corrections(deltas.astype(np.float64), n, 32,
                                        cfg.path_smooth_max, t)
        np.testing.assert_allclose(e, e_ref, atol=1e-6)
        np.testing.assert_allclose(d, d_ref, atol=1e-6)

    def test_clamp_and_antiwindup(self):
        t, n = 6, 3
        deltas = np.zeros((t + n - 2, 2), np.float32)
        deltas[2] = (0.5, -0.5)
        cfg = StabilizeConfig(model=ModelConfig(window=n), path_smooth=16,
                              path_smooth_max=0.03)
        e, _ = _corr(cfg, deltas, t)
        assert np.abs(e).max() <= 0.03 + 1e-6
        e_ref, _ = _ref_corrections(deltas.astype(np.float64), n, 16, 0.03,
                                    t)
        np.testing.assert_allclose(e, e_ref, atol=1e-6)

    def test_split_equals_whole(self):
        rng = np.random.default_rng(1)
        t, n = 12, 5
        deltas = rng.normal(0, 0.02, (t + n - 2, 2)).astype(np.float32)
        cfg = StabilizeConfig(model=ModelConfig(window=n), path_smooth=24)
        e_all, _ = _corr(cfg, deltas, t)
        e1, d1 = _corr(cfg, deltas[:6 + n - 2], 6)
        e2, _ = _corr(cfg, deltas[6:], 6, state=torch.from_numpy(d1))
        np.testing.assert_allclose(np.concatenate([e1, e2]), e_all,
                                   atol=1e-7)

    def test_cut_resets_recursion(self):
        t, n = 10, 3
        deltas = np.full((t + n - 2, 2), 0.01, np.float32)
        cuts = np.zeros((t + n - 2,), bool)
        cuts[5] = True
        deltas[5] = 0.0
        cfg = StabilizeConfig(model=ModelConfig(window=n), path_smooth=16)
        e, d = _corr(cfg, deltas, t, cuts=cuts)
        # The cut is consumed at output frame 5 - (n - 2) = 4: e restarts.
        np.testing.assert_allclose(e[4], 0.0, atol=1e-7)
        e_ref, d_ref = _ref_corrections(deltas.astype(np.float64), n, 16,
                                        cfg.path_smooth_max, t, cuts=cuts)
        np.testing.assert_allclose(e, e_ref, atol=1e-6)
        np.testing.assert_allclose(d, d_ref, atol=1e-6)


class TestPipeline:
    @pytest.mark.parametrize("cfg", [CFG, LAG_CFG], ids=["causal", "lag"])
    def test_chunk_size_invariant(self, params, cfg):
        frames = _clip(11)
        out2 = Stabilizer(cfg.replace(chunk_frames=4), params,
                          device="cpu").stabilize_clip(frames)
        out8 = Stabilizer(cfg.replace(chunk_frames=8), params,
                          device="cpu").stabilize_clip(frames)
        np.testing.assert_array_equal(out2, out8)

    @pytest.mark.parametrize("mode", [m for m, _ in MODES])
    def test_modes_invariant_fuzz(self, params, mode):
        """Seeded clip length and chunk-size pair, per smoothing mode."""
        seed = [m for m, _ in MODES].index(mode)
        rng = np.random.default_rng(seed)
        frames = _clip(int(rng.integers(9, 18)), key=400 + seed)
        cfg = CFG.replace(**dict(MODES)[mode])
        sizes = [4, 6, 8] if mode == "lag" else [2, 4, 8]   # lag: T >= D
        c_lo, c_hi = sorted(rng.choice(sizes, 2, replace=False))
        outs = [Stabilizer(cfg.replace(chunk_frames=int(c)), params,
                           device="cpu").stabilize_clip(frames)
                for c in (c_lo, c_hi)]
        np.testing.assert_array_equal(*outs)

    def test_smoothing_changes_output_and_resets_between_clips(self,
                                                                params):
        frames = _clip(8, key=4)
        stab = Stabilizer(CFG, params, device="cpu")
        on = stab.stabilize_clip(frames)
        np.testing.assert_array_equal(stab.stabilize_clip(frames), on)
        off = Stabilizer(CFG.replace(path_smooth=0), params,
                         device="cpu").stabilize_clip(frames)
        assert not np.array_equal(on, off)

    def test_lag_differs_from_causal(self, params):
        frames = _clip(11)
        lag = Stabilizer(LAG_CFG, params, device="cpu").stabilize_clip(
            frames)
        causal = Stabilizer(CFG, params, device="cpu").stabilize_clip(frames)
        assert lag.shape == frames.shape
        assert not np.array_equal(lag, causal)

    def test_cut_clip_recovers_to_fresh_stream(self, params):
        """After a hard cut the gated output converges to a fresh stream
        of the second scene; ungated, the cut's delta persists."""
        from dvsg_tpu_torch.utils.metrics import psnr
        a, b = _clip(8, key=21, h=64, w=80), _clip(8, key=22, h=64, w=80)
        both = np.concatenate([a, b])
        fresh = Stabilizer(CFG, params, device="cpu").stabilize_clip(b)
        gated = Stabilizer(CFG, params, device="cpu").stabilize_clip(both)
        ungated = Stabilizer(CFG.replace(path_smooth_conf=0.0,
                                         path_smooth_cut=0.0), params,
                             device="cpu").stabilize_clip(both)
        p_gated = psnr(gated[12:16], fresh[4:8])
        p_ungated = psnr(ungated[12:16], fresh[4:8])
        assert p_gated > 40.0 and p_gated > p_ungated + 3.0, (p_gated,
                                                              p_ungated)

    def test_flat_stretch_decays_instead_of_garbage(self, params):
        a = _clip(8, key=23, h=64, w=80)
        rng = np.random.default_rng(0)
        flat = np.clip(128 + rng.normal(0, 1.5, (8, 64, 80, 3)), 0,
                       255).astype(np.uint8)
        clip = np.concatenate([a, flat])
        run = lambda cfg: Stabilizer(cfg, params, device="cpu"
                                     ).stabilize_clip(clip)[10:].astype(int)
        gated = run(CFG)
        ungated = run(CFG.replace(path_smooth_conf=0.0, path_smooth_cut=0.0))
        plain = run(CFG.replace(path_smooth=0))
        assert np.abs(gated - plain).mean() <= np.abs(ungated - plain).mean()


class TestStream:
    @pytest.mark.parametrize("cfg", [CFG, LAG_CFG], ids=["causal", "lag"])
    def test_stream_equals_clip(self, params, cfg):
        frames = _clip(14)
        want = Stabilizer(cfg, params, device="cpu").stabilize_clip(frames)
        w = _Writer(len(frames), frames.shape[1:])
        n = Stabilizer(cfg, params, device="cpu").stabilize_stream(
            _Reader(frames), w)
        assert n == len(frames)
        np.testing.assert_array_equal(w.frames, want)

    @pytest.mark.parametrize("cfg,fail_at,at", [
        (CFG, 2, 8), (LAG_CFG, 1, 4), (LAG_CFG, 3, 12)],
        ids=["causal", "lag-midstream", "lag-drain"])
    def test_resume_is_byte_identical(self, params, tmp_path, cfg, fail_at,
                                      at):
        frames = _clip(14, key=5)
        want = Stabilizer(cfg, params, device="cpu").stabilize_clip(frames)
        rdir = str(tmp_path / "r")
        stab = Stabilizer(cfg, params, device="cpu")
        first = _interrupted(stab, frames, rdir, fail_at)
        with np.load(os.path.join(rdir, "resume_state.npz")) as z:
            assert int(z["frames_written"]) == at
        w = _Writer(len(frames), frames.shape[1:])
        w.frames[:at] = first.frames[:at]
        stab.stabilize_stream(_Reader(frames), w, resume_dir=rdir)
        np.testing.assert_array_equal(w.frames, want)

    @pytest.mark.parametrize("written,resumed,match", [
        (CFG.replace(path_smooth=0), CFG, "without path smoothing"),
        (CFG, CFG.replace(path_smooth=0), "carries a path-smoothing"),
        (LAG_CFG, CFG, "path-smooth-lag run"),
        (CFG, LAG_CFG, "without the lag smoother"),
    ])
    def test_resume_record_mismatches_raise(self, params, tmp_path, written,
                                            resumed, match):
        frames = _clip(8, key=7)
        rdir = str(tmp_path / "r")
        Stabilizer(written, params, device="cpu").stabilize_stream(
            _Reader(frames[:4 + written.path_smooth_lag]),
            _Writer(8, frames.shape[1:]), resume_dir=rdir)
        with pytest.raises(ValueError, match=match):
            Stabilizer(resumed, params, device="cpu").stabilize_stream(
                _Reader(frames), _Writer(8, frames.shape[1:]),
                resume_dir=rdir)

    def test_old_two_component_state_resumes(self, params):
        """A (2,) state of an older record starts rotation and scale as a
        fresh EMA."""
        stab = Stabilizer(CFG, params, device="cpu")
        stab.begin_stream(
            {"smooth_state": np.array([0.01, -0.02], np.float32)})
        np.testing.assert_array_equal(
            stab.step.record()["smooth_state"],
            np.array([0.01, -0.02, 0.0, 0.0], np.float32))

    @pytest.mark.parametrize("cfg", [CFG.replace(path_smooth=0), CFG,
                                     LAG_CFG],
                             ids=["plain", "causal", "lag"])
    def test_clip_stream_and_batch_loops_give_the_same_bytes(
            self, params, tmp_path, cfg):
        """The one clip, stream and batch loop over the one step: on a clip
        that is not a multiple of T and on one shorter than D, the stream
        (cut after its first write and resumed from the record at that
        chunk boundary, or, where the clip takes one write, resumed after
        its end) and a one-clip batch give the clip's bytes."""
        for n in (10, 3):
            frames = _clip(n, key=n)
            stab = Stabilizer(cfg, params, device="cpu")
            want = stab.stabilize_clip(frames)
            assert want.shape == frames.shape
            batch = tstab.drive_chunked_batch(
                tstab.ChunkStep(cfg, stab.model, batched=True), frames[None])
            np.testing.assert_array_equal(batch[0], want)
            rdir = str(tmp_path / f"r{n}")
            if n == 10:
                w = _interrupted(stab, frames, rdir, 1)
                w.fail_at = None
            else:
                w = _Writer(n, frames.shape[1:])
                assert stab.stabilize_stream(_Reader(frames), w,
                                             resume_dir=rdir) == n
            with np.load(os.path.join(rdir, "resume_state.npz")) as z:
                assert int(z["frames_written"]) == min(n, 4)
            again = Stabilizer(cfg, params, device="cpu")
            assert again.stabilize_stream(_Reader(frames), w,
                                          resume_dir=rdir) == n
            np.testing.assert_array_equal(w.frames, want)


class TestConfig:
    @pytest.mark.parametrize("kw,match", [
        (dict(path_smooth=-1), "path_smooth"),
        (dict(model=ModelConfig(window=1), path_smooth=8), "window >= 2"),
        (dict(path_smooth=8, path_smooth_max=0.5), "path_smooth_max"),
        (dict(path_smooth_lag=4), "path_smooth_lag needs"),
        (dict(path_smooth=8, path_smooth_lag=32), "chunk_frames"),
        (dict(path_smooth=8, path_smooth_conf=1.0, path_smooth_cut=2.0),
         "path_smooth_cut"),
        (dict(queue_depth=0), "queue_depth"),
    ])
    def test_rejects(self, kw, match):
        with pytest.raises(ValueError, match=match):
            StabilizeConfig(**kw)

    def test_fields_and_defaults_match_reference(self):
        names = ("path_smooth", "path_smooth_max", "path_smooth_rotation",
                 "path_smooth_scale", "path_smooth_conf", "path_smooth_cut",
                 "path_smooth_lag", "queue_depth")
        ours, ref = StabilizeConfig(), JStabilizeConfig()
        assert {k: getattr(ours, k) for k in names} \
            == {k: getattr(ref, k) for k in names}

    def test_unsupported_helpers_raise(self):
        with pytest.raises(ValueError, match="path_smooth"):
            ps.reject_unsupported(CFG, "a custom loop")
        ps.reject_unsupported(CFG.replace(path_smooth=0), "a custom loop")
        with pytest.raises(ValueError, match="path_smooth_lag"):
            ps.lag_reject(LAG_CFG, "a live surface")


def test_sway_shrinks_and_tracks_ideal(fast):
    """The reason the stage exists: slow sway the CNN's window passes
    through shrinks (feature-tracked path RMS), and the output tracks the
    ideal trajectory (rendered from the true path through the same
    recursion)."""
    pytest.importorskip("cv2")
    from dvsg_tpu_torch.utils import stab_metrics
    from dvsg_tpu_torch.utils.metrics import psnr
    (params, mcfg), _ = fast
    n_fr, h, w = 64, 256, 320
    t = np.arange(n_fr)
    rng = np.random.default_rng(3)
    path5 = np.zeros((n_fr, 5), np.float32)
    path5[:, 0] = 0.05 * np.sin(2 * np.pi * t / 40) + rng.normal(0, 0.008,
                                                                 n_fr)
    path5[:, 1] = 0.04 * np.sin(2 * np.pi * t / 56 + 1.0) \
        + rng.normal(0, 0.008, n_fr)
    still = synthetic.random_still(torch.Generator().manual_seed(11), h, w)
    render = lambda p: synthetic.to_u8(synthetic.jitter_frames(
        still, torch.from_numpy(p))).numpy()
    frames = render(path5)
    torch.set_num_threads(4)     # one large test: the CNN on 128 frames
    try:
        outs = {hz: Stabilizer(StabilizeConfig(
            model=mcfg, chunk_frames=16, path_smooth=hz,
            path_smooth_rotation=False, path_smooth_scale=False), params,
            device="cpu").stabilize_clip(frames) for hz in (0, 32)}
    finally:
        torch.set_num_threads(1)

    def rms(x):
        cp = np.nan_to_num(stab_metrics.camera_path(x))
        p = np.cumsum(cp[:, :2], axis=0)
        return float(np.sqrt(((p - p.mean(0)) ** 2).mean()))

    assert rms(outs[32]) < 0.75 * rms(outs[0])
    n = mcfg.window
    p = path5[:, :2].astype(np.float64)
    pad = np.concatenate([np.repeat(p[:1], n - 1, 0), p])
    abar = np.stack([pad[i:i + n].mean(0) for i in range(n_fr)])
    e_ref, _ = _ref_corrections(
        np.concatenate([np.zeros((n - 1, 2)), np.diff(p, axis=0)]), n, 32,
        0.05, n_fr)
    th = np.zeros_like(path5)
    th[:, :2] = abar + e_ref
    target = render(th)
    bh, bw = int(h * 0.15), int(w * 0.15)
    inner = lambda a: a[:, bh:h - bh, bw:w - bw]
    assert psnr(inner(outs[32]), inner(target)) > 45.0
